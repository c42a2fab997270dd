// Exact top-k cosine search over a float32 gallery, for sm_90a.
//
// Replaces the Pallas kernel `_topk_tile_kernel` behind
// `pallas_cosine_topk` (facerecognition_tpu/ops/pallas_topk.py). It computes
// the same function, not the same tiling: the TPU kernel carries one running
// top-k across a sequential grid, while Hopper runs blocks in parallel, so
//
//   pass 1 (topk_partial): grid (n_split, ceil(B / BQ)). A block owns a
//     contiguous run of gallery rows and BQ queries. It stages (DK-wide)
//     slices of a 128-row gallery tile and of its queries in shared memory,
//     computes the scores with float32 FMA (each thread a TQ x TR register
//     tile, TQ chosen by k and the batch), and folds every score into
//     per-thread top-k lists held in registers. Gallery row norms are summed while the tile is staged, so
//     the gallery is read once and never normalised in device memory.
//     Rows >= N never enter: the ragged edge is masked, not padded. Each
//     thread writes its k best per query as candidates to scratch.
//   pass 2 (topk_merge): one block per query merges the candidates.
//
// Order everywhere is (score descending, index ascending), so ties resolve
// to the lowest gallery row, as lax.top_k does. Indices are int32 end to
// end. Slots left unfilled (k > N) come out as score -1e30, index 0, as the
// Pallas wrapper clamps them.
//
// What bounds it: at the serving match shape (B=128 queries, N=1,000,000
// rows, D=512) it must read 2.05 GB and do 134 GFLOP. At the H100 SXM's
// published 3.35 TB/s and 67 TFLOP/s (float32, no tensor cores) that is
// max(0.61 ms, 2.0 ms): this first design is bound by float32 FMA
// throughput. Its register tile gives 32 FMAs per 12 shared-memory loads.
// A TF32 or bf16 wgmma design is the way past that bound.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int TX = 16;           // row lanes of a block
constexpr int TY = 16;           // query lanes of a block
constexpr int TR = 8;            // rows per thread per tile
constexpr int BR = TX * TR;      // gallery rows per tile
constexpr int DK = 16;           // dims per shared-memory stage
constexpr int THREADS = TX * TY;
constexpr int GLOADS = BR * DK / 4 / THREADS;  // float4 gallery loads per thread
constexpr int MERGE_THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr float UNFILLED_SCORE = -1e30f;

static_assert(BR * DK / 4 % THREADS == 0, "gallery stage must split evenly");

__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// Insert (s, i) into a list kept sorted best first; a full list drops its
// worst entry. All indices are compile-time, so the list stays in registers.
template <int KMAX>
__device__ __forceinline__ void insert(float (&ts)[KMAX], int (&ti)[KMAX],
                                       float s, int i) {
  if (!better(s, i, ts[KMAX - 1], ti[KMAX - 1])) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (better(s, i, ts[j], ti[j])) {
      const float fs = ts[j];
      const int fi = ti[j];
      ts[j] = s;
      ti[j] = i;
      s = fs;
      i = fi;
    }
  }
}

template <int KMAX, int TQ>
__global__ void __launch_bounds__(THREADS)
    topk_partial(const float* __restrict__ q, const float* __restrict__ g,
                 int B, int N, int D, int k, int rows_per_split,
                 float* __restrict__ cand_s, int* __restrict__ cand_i) {
  constexpr int BQ = TY * TQ;
  __shared__ __align__(16) float qs[DK][BQ];
  __shared__ __align__(16) float gs[DK][BR];
  __shared__ float ginv[BR];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int lt = ty * TX + tx;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);

  float ts[TQ][KMAX];
  int ti[TQ][KMAX];
#pragma unroll
  for (int u = 0; u < TQ; ++u) {
#pragma unroll
    for (int m = 0; m < KMAX; ++m) {
      ts[u][m] = -INFINITY;
      ti[u][m] = INT_MAX;
    }
  }

  for (int t0 = r_begin; t0 < r_end; t0 += BR) {
    float acc[TQ][TR];
#pragma unroll
    for (int u = 0; u < TQ; ++u) {
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[u][j] = 0.f;
    }
    float sq[GLOADS];
#pragma unroll
    for (int p = 0; p < GLOADS; ++p) sq[p] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      for (int e = lt; e < BQ * (DK / 4); e += THREADS) {
        const int qq = e / (DK / 4);
        const int c = (e % (DK / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + qq < B && d0 + c < D)
          v = *reinterpret_cast<const float4*>(q + (size_t)(q0 + qq) * D + d0 + c);
        qs[c + 0][qq] = v.x;
        qs[c + 1][qq] = v.y;
        qs[c + 2][qq] = v.z;
        qs[c + 3][qq] = v.w;
      }
#pragma unroll
      for (int p = 0; p < GLOADS; ++p) {
        const int e = lt + p * THREADS;
        const int rr = e / (DK / 4);
        const int c = (e % (DK / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t0 + rr < r_end && d0 + c < D)
          v = __ldg(reinterpret_cast<const float4*>(g + (size_t)(t0 + rr) * D + d0 + c));
        gs[c + 0][rr] = v.x;
        gs[c + 1][rr] = v.y;
        gs[c + 2][rr] = v.z;
        gs[c + 3][rr] = v.w;
        sq[p] = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, sq[p]))));
      }
      __syncthreads();
#pragma unroll
      for (int dk = 0; dk < DK; ++dk) {
        float a[TQ], b[TR];
#pragma unroll
        for (int u = 0; u < TQ; ++u) a[u] = qs[dk][ty * TQ + u];
#pragma unroll
        for (int j = 0; j < TR; ++j) b[j] = gs[dk][tx + TX * j];
#pragma unroll
        for (int u = 0; u < TQ; ++u) {
#pragma unroll
          for (int j = 0; j < TR; ++j) acc[u][j] = fmaf(a[u], b[j], acc[u][j]);
        }
      }
      __syncthreads();
    }

    // The DK/4 float4 slots of one row are loaded by neighbouring lanes.
#pragma unroll
    for (int p = 0; p < GLOADS; ++p) {
      float s = sq[p];
#pragma unroll
      for (int off = 1; off < DK / 4; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if ((lt % (DK / 4)) == 0) ginv[(lt + p * THREADS) / (DK / 4)] = 1.f / fmaxf(sqrtf(s), 1e-12f);
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int rr = tx + TX * j;
      if (t0 + rr < r_end) {
        const float inv = ginv[rr];
#pragma unroll
        for (int u = 0; u < TQ; ++u) insert<KMAX>(ts[u], ti[u], acc[u][j] * inv, t0 + rr);
      }
    }
    // ginv is rewritten only after the next tile's first __syncthreads.
  }

#pragma unroll
  for (int u = 0; u < TQ; ++u) {
    const int qi = q0 + ty * TQ + u;
    if (qi >= B) continue;
    const size_t base = (((size_t)qi * gridDim.x + split) * TX + tx) * k;
#pragma unroll
    for (int m = 0; m < KMAX; ++m) {
      if (m < k) {
        cand_s[base + m] = ts[u][m];
        cand_i[base + m] = ti[u][m];
      }
    }
  }
}

template <int KMAX>
__global__ void __launch_bounds__(MERGE_THREADS)
    topk_merge(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
               int n_cand, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ float ws[MERGE_THREADS / 32];
  __shared__ int wi[MERGE_THREADS / 32];
  __shared__ float best_s;
  __shared__ int best_i;

  const int qi = blockIdx.x;
  const float* cs = cand_s + (size_t)qi * n_cand;
  const int* ci = cand_i + (size_t)qi * n_cand;

  float ts[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int m = 0; m < KMAX; ++m) {
    ts[m] = -INFINITY;
    ti[m] = INT_MAX;
  }
  for (int c = threadIdx.x; c < n_cand; c += MERGE_THREADS) insert<KMAX>(ts, ti, cs[c], ci[c]);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int m = 0; m < k; ++m) {
    float s = ts[0];
    int i = ti[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, s, off);
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
      out_s[(size_t)qi * k + m] = filled ? s : UNFILLED_SCORE;
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
      ts[KMAX - 1] = -INFINITY;
      ti[KMAX - 1] = INT_MAX;
    }
  }
}

// Queries per thread: the register budget allows 4 lists of 8, 2 of 16 or
// 1 of 32; a small batch takes the fewest that cover it, since the rows of
// a block beyond B are computed and thrown away.
int queries_per_thread(int B, int k) {
  const int most = k <= 8 ? 4 : (k <= 16 ? 2 : 1);
  int tq = 1;
  while (tq < most && TY * tq < B) tq *= 2;
  return tq;
}

template <int KMAX, int TQ>
void launch(const float* q, const float* g, int B, int N, int D, int k, int n_split,
            int rows_per_split, float* cand_s, int* cand_i, float* out_s, int* out_i,
            cudaStream_t stream) {
  const dim3 grid(n_split, (B + TY * TQ - 1) / (TY * TQ));
  topk_partial<KMAX, TQ><<<grid, dim3(TX, TY), 0, stream>>>(q, g, B, N, D, k, rows_per_split,
                                                            cand_s, cand_i);
  topk_merge<KMAX><<<B, MERGE_THREADS, 0, stream>>>(cand_s, cand_i, n_split * TX * k, k,
                                                    out_s, out_i);
}

}  // namespace

extern "C" {

// Work split for (B, N, k) on a card with `sm_count` SMs: several blocks per
// SM, each over whole 128-row tiles. `n_cand` is the candidates per query
// that pass 1 writes (scratch is B * n_cand floats and as many ints).
int stream_topk_plan(int B, int N, int k, int sm_count, int* n_split, int* rows_per_split,
                     int* n_cand) {
  if (B < 1 || N < 1 || k < 1 || k > 32 || sm_count < 1) return -1;
  const int bq = TY * queries_per_thread(B, k);
  const int grid_y = (B + bq - 1) / bq;
  const int n_tiles = (N + BR - 1) / BR;
  int split = (BLOCKS_PER_SM * sm_count + grid_y - 1) / grid_y;
  split = split < 1 ? 1 : (split > n_tiles ? n_tiles : split);
  const int tiles_per_split = (n_tiles + split - 1) / split;
  *rows_per_split = tiles_per_split * BR;
  *n_split = (N + *rows_per_split - 1) / *rows_per_split;
  *n_cand = *n_split * TX * k;
  return 0;
}

// q (B, D) unit rows, g (N, D) any rows, both float32 row-major with
// D % 4 == 0 and 16-byte aligned. Returns cudaGetLastError() after the
// launches (0 on success).
int stream_topk_launch(const float* q, const float* g, int B, int N, int D, int k, int n_split,
                       int rows_per_split, float* cand_s, int* cand_i, float* out_s, int* out_i,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tq = queries_per_thread(B, k);
#define STREAM_TOPK_LAUNCH(KMAX, TQ)                                                        \
  launch<KMAX, TQ>(q, g, B, N, D, k, n_split, rows_per_split, cand_s, cand_i, out_s, out_i, st)
  if (k <= 8) {
    if (tq == 4)
      STREAM_TOPK_LAUNCH(8, 4);
    else if (tq == 2)
      STREAM_TOPK_LAUNCH(8, 2);
    else
      STREAM_TOPK_LAUNCH(8, 1);
  } else if (k <= 16) {
    if (tq == 2)
      STREAM_TOPK_LAUNCH(16, 2);
    else
      STREAM_TOPK_LAUNCH(16, 1);
  } else {
    STREAM_TOPK_LAUNCH(32, 1);
  }
#undef STREAM_TOPK_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
