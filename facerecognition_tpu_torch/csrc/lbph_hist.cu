// LBPH features: circular LBP codes and cell histograms, for sm_90a.
//
// Replaces the XLA graph of facerecognition_tpu/models/lbph.py lbph_features
// (lbp_code_image + spatial_histogram; not a Pallas kernel), vmapped over a
// batch of gray images. Its plain PyTorch version is
// ops/lbph_hist.lbph_features_plain.
//
// A block per band: a row of cells of one image (or, where the band's
// histograms do not fit in shared memory, a run of `seg` cells of it). It
// stages the band's pixel rows and the 2r-pixel halo in shared memory once
// (in slabs of rows when they do not fit), keeps the band's cell
// histograms as int counts in shared memory, and puts every thread on a
// pixel: warp w takes code rows w, w + WARPS, ..., lane l columns l, l + 32,
// ...; each pixel's code is computed in registers from the staged taps and
// counted with a shared-memory atomicAdd in its cell's histogram. After a
// barrier the block writes its cells' rows (contiguous in the output) with
// 16-byte stores, each count times float32(1 / pixels of a cell) by
// __fmul_rn. Above 8192 bins a cell (neighbours 14-16) the histogram is the
// output row itself: zeroed, counted with float atomics (exact below 2^24)
// and scaled in place.
//
// The codes are JAX's bits. A neighbour's tap sum w1*a + w2*b + w3*c + w4*d
// can miss the centre of a flat region by 1e-5 at 200, far above the bit
// test's eps, so the bit depends on how the sum rounds. The host passes the
// plan of XLA's CPU graph (ops/lbph_hist.tap_plan, as plan_words); the
// launcher turns it into kernel parameters, with no run-time branch on the
// plan: every step is one fma whose operands say which rounding it does.
//   step 0: ADD        fl(v0 w0) + fl(v1 w1)  = fma(fl(v0 w0), 1, fl(v1 w1))
//           FMA_LEFT   fma(v0, w0, fl(v1 w1)) = fma(fl(v0 * 1), w0, fl(v1 w1))
//           FMA_RIGHT  fma(v1, w1, fl(v0 w0)): FMA_LEFT with taps 0 and 1 swapped
//   steps 1-2: ADD     t + fl(v w)            = fma(fl(v w), 1, t)
//           FMA_RIGHT  fma(v, w, t)           = fma(fl(v * 1), w, t)
// so a tap k is first rounded as fl(v * m_k) and step s fuses with y_s
// (m, y in {w, 1}); v * 1 and x * 1 + t are exact, so each form rounds as
// its plan says, NaN, infinities and signed zeros included. The weights,
// the multipliers and the taps' shared-memory offsets are kernel
// parameters (constant-bank operands). The arithmetic is written with
// explicit roundings so nvcc contracts nothing else; the file is built
// without fast math.
//
// For the plans of (r 1, P 8) and (r 2, P 8) the taps' offsets are also
// compiled in (STATIC_TAPS): a pixel reads its (2r + 1)^2 window into
// registers once instead of 32 taps from shared memory.
//
// What bounds it: bytes. Each image is read once (40 KB at 100x100; the
// halo rows a second time, 2r / cell rows more) and its histograms written
// once (64 KB at 8x8 cells of 256 bins): 13.4 MB for 128 images, about
// 4 us at 3.35 TB/s. Per pixel: 9 (r 1) or 25 (r 2) shared-memory loads,
// 4 products and 3 fmas per neighbour, one shared-memory atomic.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <cstring>

// Mirrors ops/lbph_hist._Args field for field (outside the unnamed namespace:
// the C launcher takes it).
struct LbphArgs {
  const float* images;  // (B, H, W) float32
  const int* plan;      // host memory: (neighbors, PLAN_WORDS) int32, ops/lbph_hist.plan_words
  float* out;           // (B, grid_y * grid_x * 2^P) float32
  int B, H, W, radius, neighbors, grid_x, grid_y, cell_h, cell_w;
  float inv_cell;
};

namespace {

constexpr int MAX_NEIGHBORS = 16;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM_BINS = 8192;        // bins of a cell counted in shared memory
constexpr int HIST_BYTES = 32 * 1024;      // the shared-memory histograms of a block
constexpr int STAGE_FLOATS = 12 * 1024;    // the staged pixels of a slab (48 KB)
constexpr int ADD = 0, FMA_RIGHT = 2;  // ops/lbph_hist: ADD, FMA_LEFT = 1, FMA_RIGHT

// One neighbour's words of the plan: dy[4], dx[4], the weights' float32
// bits[4], op[3] (how steps 0-2 join the next term) and a pad.
constexpr int PLAN_WORDS = 16;
constexpr int DY = 0, DX = 4, WT = 8, OP = 12;

// The plan as kernel parameters: per neighbour the taps' offsets from the
// centre in the staged tile, m[k] (tap k is rounded as v * m[k]) and y[s]
// (step s fuses with it); see the header.
struct Taps {
  int off[MAX_NEIGHBORS][4];
  float m[MAX_NEIGHBORS][4];
  float y[MAX_NEIGHBORS][3];
};

// How the block walks its band.
struct Band {
  int seg;            // cells of a block
  int segs;           // blocks per band
  int slab;           // code rows staged at a time
  int pitch;          // floats of a staged row: seg * cell_w + 2r (rounded up to 4 with vec)
  int vec;            // stage by 16-byte loads (rows and block columns 16-byte aligned)
};

// The taps' offsets (dy, dx) of the plans of (r 1, P 8) and (r 2, P 8), in
// the launcher's order (taps 0 and 1 swapped where step 0 is FMA_RIGHT).
// tests/test_torch_lbph_band.py holds them against ops/lbph_hist.plan_words,
// and the launcher takes the kernel specialised on them only for a plan
// whose offsets are these: its taps come from a (2r + 1)^2 window of
// registers, 9 or 25 loads a pixel instead of 32. The table is local to the
// function, so device code reads it as a constant expression.
__host__ __device__ constexpr int static_tap(int radius, int n, int k, int d) {
  constexpr int STATIC_TAPS[2][8][4][2] = {
      {{{0, 1}, {0, 1}, {0, 1}, {0, 1}},
       {{-1, 1}, {-1, 0}, {0, 0}, {0, 1}},
       {{-1, 1}, {-1, 0}, {-1, 0}, {-1, 1}},
       {{-1, -1}, {-1, 0}, {0, -1}, {0, 0}},
       {{-1, -1}, {-1, -1}, {0, -1}, {0, -1}},
       {{0, -1}, {0, 0}, {1, -1}, {1, 0}},
       {{1, -1}, {1, 0}, {1, -1}, {1, 0}},
       {{0, 0}, {0, 1}, {1, 0}, {1, 1}}},
      {{{0, 2}, {0, 2}, {0, 2}, {0, 2}},
       {{-2, 1}, {-2, 2}, {-1, 1}, {-1, 2}},
       {{-2, 1}, {-2, 0}, {-2, 0}, {-2, 1}},
       {{-2, -2}, {-2, -1}, {-1, -2}, {-1, -1}},
       {{-1, -2}, {-1, -2}, {0, -2}, {0, -2}},
       {{1, -2}, {1, -1}, {2, -2}, {2, -1}},
       {{2, -1}, {2, 0}, {2, -1}, {2, 0}},
       {{1, 1}, {1, 2}, {2, 1}, {2, 2}}},
  };
  return STATIC_TAPS[radius - 1][n][k][d];
}

// One neighbour's bit from its four taps (see the header).
__device__ __forceinline__ int neighbour_bit(float v0, float v1, float v2, float v3, float centre,
                                             const Taps& tp, int n) {
  float t = __fmaf_rn(__fmul_rn(v0, tp.m[n][0]), tp.y[n][0], __fmul_rn(v1, tp.m[n][1]));
  t = __fmaf_rn(__fmul_rn(v2, tp.m[n][2]), tp.y[n][1], t);
  t = __fmaf_rn(__fmul_rn(v3, tp.m[n][3]), tp.y[n][2], t);
  return (t > centre) | (fabsf(__fsub_rn(t, centre)) < FLT_EPSILON);
}

// Neighbours N..7 of the plan with STATIC_TAPS[R - 1], their taps from the
// pixel's (2R + 1)^2 window of registers.
template <int R, int N = 0>
__device__ __forceinline__ int static_code(const float (&win)[2 * R + 1][2 * R + 1],
                                           const Taps& tp) {
  if constexpr (N == 8) {
    return 0;
  } else {
    constexpr int y0 = R + static_tap(R, N, 0, 0), x0 = R + static_tap(R, N, 0, 1);
    constexpr int y1 = R + static_tap(R, N, 1, 0), x1 = R + static_tap(R, N, 1, 1);
    constexpr int y2 = R + static_tap(R, N, 2, 0), x2 = R + static_tap(R, N, 2, 1);
    constexpr int y3 = R + static_tap(R, N, 3, 0), x3 = R + static_tap(R, N, 3, 1);
    return neighbour_bit(win[y0][x0], win[y1][x1], win[y2][x2], win[y3][x3], win[R][R], tp, N)
               << N |
           static_code<R, N + 1>(win, tp);
  }
}

// The code of the pixel whose centre is at c in the staged tile. R > 0 (8
// neighbours): the taps of STATIC_TAPS[R - 1] from a register window; R = 0:
// `neighbors` (<= 16) neighbours, their taps read at tp.off.
template <int R>
__device__ __forceinline__ int lbp_code(const float* c, int pitch, const Taps& tp, int neighbors) {
  int code = 0;
  if constexpr (R > 0) {
    constexpr int S = 2 * R + 1;
    float win[S][S];
#pragma unroll
    for (int dy = 0; dy < S; ++dy)
#pragma unroll
      for (int dx = 0; dx < S; ++dx) win[dy][dx] = c[(dy - R) * pitch + dx - R];
    return static_code<R>(win, tp);
  }
  const float centre = c[0];
#pragma unroll
  for (int n = 0; n < MAX_NEIGHBORS; ++n) {
    if (n >= neighbors) break;
    code |= neighbour_bit(c[tp.off[n][0]], c[tp.off[n][1]], c[tp.off[n][2]], c[tp.off[n][3]],
                          centre, tp, n)
            << n;
  }
  return code;
}

template <int R, bool SMEM>
__global__ void __launch_bounds__(THREADS)
    lbph_hist(const __grid_constant__ LbphArgs a, const __grid_constant__ Taps tp, const Band bd) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bins = 1 << a.neighbors;
  const int band = blockIdx.x / bd.segs;
  const int cx0 = (blockIdx.x % bd.segs) * bd.seg;
  const int ncell = min(bd.seg, a.grid_x - cx0);
  const int width = ncell * a.cell_w;  // code columns of the block
  const int r = a.radius;
  int* hist = smem;
  // the staged rows after the histograms, 16-byte aligned
  float* tile = reinterpret_cast<float*>(smem + (SMEM ? (bd.seg * bins + 3) / 4 * 4 : 0));
  const float* img = a.images + (size_t)blockIdx.y * a.H * a.W;
  float* out = a.out + ((size_t)blockIdx.y * a.grid_x * a.grid_y + band * a.grid_x + cx0) * bins;
  const int count = ncell * bins;  // the block's bins, contiguous in the output
  const bool vec = bins % 4 == 0;
  if (vec) {
    for (int k = 4 * threadIdx.x; k < count; k += 4 * THREADS) {
      if (SMEM) *reinterpret_cast<int4*>(hist + k) = make_int4(0, 0, 0, 0);
      else *reinterpret_cast<float4*>(out + k) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int k = threadIdx.x; k < count; k += THREADS) {
      if (SMEM) hist[k] = 0;
      else out[k] = 0.0f;
    }
  }
  for (int y0 = 0; y0 < a.cell_h; y0 += bd.slab) {
    const int rows = min(bd.slab, a.cell_h - y0);
    __syncthreads();  // the zeroing is done, the previous slab's taps read
    const float* src = img + (size_t)(band * a.cell_h + y0) * a.W + cx0 * a.cell_w;
    if (bd.vec) {
      for (int i = warp; i < rows + 2 * r; i += WARPS)
        for (int j = lane; j < bd.pitch / 4; j += 32)
          reinterpret_cast<float4*>(tile + i * bd.pitch)[j] =
              reinterpret_cast<const float4*>(src + (size_t)i * a.W)[j];
    } else {
      for (int i = warp; i < rows + 2 * r; i += WARPS)
        for (int j = lane; j < width + 2 * r; j += 32) tile[i * bd.pitch + j] = src[(size_t)i * a.W + j];
    }
    __syncthreads();
    for (int j = lane; j < width; j += 32) {
      const int bin0 = (j / a.cell_w) * bins;
      for (int i = warp; i < rows; i += WARPS) {
        const int code = lbp_code<R>(tile + (i + r) * bd.pitch + j + r, bd.pitch, tp, a.neighbors);
        if (SMEM) atomicAdd(&hist[bin0 + code], 1);
        else atomicAdd(&out[bin0 + code], 1.0f);
      }
    }
  }
  __syncthreads();
  // the float path's counts were added at L2: read them past L1
  if (vec) {
    for (int k = 4 * threadIdx.x; k < count; k += 4 * THREADS) {
      float4 v;
      if (SMEM) {
        const int4 h = *reinterpret_cast<const int4*>(hist + k);
        v = make_float4((float)h.x, (float)h.y, (float)h.z, (float)h.w);
      } else {
        v = __ldcg(reinterpret_cast<const float4*>(out + k));
      }
      v.x = __fmul_rn(v.x, a.inv_cell);
      v.y = __fmul_rn(v.y, a.inv_cell);
      v.z = __fmul_rn(v.z, a.inv_cell);
      v.w = __fmul_rn(v.w, a.inv_cell);
      *reinterpret_cast<float4*>(out + k) = v;
    }
  } else {
    for (int k = threadIdx.x; k < count; k += THREADS) {
      const float v = SMEM ? (float)hist[k] : __ldcg(&out[k]);
      out[k] = __fmul_rn(v, a.inv_cell);
    }
  }
}

template <int R, bool SMEM>
cudaError_t launch(const LbphArgs& a, const Taps& tp, const Band& bd, int smem, int device,
                   cudaStream_t st) {
  const auto kernel = lbph_hist<R, SMEM>;
  static int allowed[64] = {};  // dynamic shared memory granted per device, above 48 KB
  if (smem > 48 * 1024 && !(device >= 0 && device < 64 && smem <= allowed[device])) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) allowed[device] = smem;
  }
  kernel<<<dim3(a.grid_y * bd.segs, a.B), THREADS, smem, st>>>(a, tp, bd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// See LbphArgs. Returns 0, a CUDA error code, or -1 for arguments it cannot run.
int lbph_hist_launch(const LbphArgs* args, int device, void* stream) {
  const LbphArgs& a = *args;
  if (a.B < 1 || a.neighbors < 1 || a.neighbors > MAX_NEIGHBORS || a.radius < 1 ||
      a.cell_h < 1 || a.cell_w < 1 || a.grid_x < 1 || a.grid_y < 1 ||
      a.grid_y * a.cell_h > a.H - 2 * a.radius || a.grid_x * a.cell_w > a.W - 2 * a.radius ||
      a.B > 65535)
    return -1;
  const int bins = 1 << a.neighbors;
  const bool in_smem = bins <= MAX_SMEM_BINS;
  // cells of a block: as many as the histograms and one staged row of taps
  // (2r + 1 rows of pixels) allow
  Band bd;
  bd.seg = in_smem ? max(1, HIST_BYTES / (bins * 4)) : a.grid_x;
  bd.seg = min(bd.seg, a.grid_x);
  while (bd.seg > 1 && (bd.seg * a.cell_w + 2 * a.radius) * (2 * a.radius + 1) > STAGE_FLOATS)
    --bd.seg;
  bd.pitch = bd.seg * a.cell_w + 2 * a.radius;
  bd.segs = (a.grid_x + bd.seg - 1) / bd.seg;
  // 16-byte staging: image rows and every block's first column aligned, and
  // the rounded-up row inside the image
  const int pitch4 = (bd.pitch + 3) / 4 * 4;
  bd.vec = a.W % 4 == 0 && reinterpret_cast<uintptr_t>(a.images) % 16 == 0 &&
           (bd.segs == 1 || bd.seg * a.cell_w % 4 == 0) &&
           (bd.segs - 1) * bd.seg * a.cell_w + pitch4 <= a.W;
  if (bd.vec) bd.pitch = pitch4;
  bd.slab = min(a.cell_h, STAGE_FLOATS / bd.pitch - 2 * a.radius);
  if (bd.slab < 1) return -1;
  if ((long long)a.grid_y * bd.segs > 2147483647LL) return -1;

  Taps tp = {};
  // the specialised kernel needs STATIC_TAPS' offsets
  bool statics = a.neighbors == 8 && (a.radius == 1 || a.radius == 2);
  for (int n = 0; n < a.neighbors; ++n) {
    const int* w = a.plan + n * PLAN_WORDS;
    int order[4] = {0, 1, 2, 3};
    if (w[OP] == FMA_RIGHT) {
      order[0] = 1;
      order[1] = 0;
    }
    for (int k = 0; k < 4; ++k) {
      tp.off[n][k] = w[DY + order[k]] * bd.pitch + w[DX + order[k]];
      if (statics)
        statics = w[DY + order[k]] == static_tap(a.radius, n, k, 0) &&
                  w[DX + order[k]] == static_tap(a.radius, n, k, 1);
      float wt;
      const int bits = w[WT + order[k]];
      std::memcpy(&wt, &bits, sizeof(wt));
      // tap 1 is always the rounded product; taps 0, 2, 3 are rounded by
      // their weight where their step adds (ADD) and by 1 where it fuses
      const bool fused = k != 1 && w[OP + (k == 0 ? 0 : k - 1)] != ADD;
      tp.m[n][k] = fused ? 1.0f : wt;
      if (k != 1) tp.y[n][k == 0 ? 0 : k - 1] = fused ? wt : 1.0f;
    }
  }

  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const int smem = (in_smem ? (bd.seg * bins + 3) / 4 * 4 * (int)sizeof(int) : 0) +
                   (bd.slab + 2 * a.radius) * bd.pitch * (int)sizeof(float);
  if (!in_smem)
    err = launch<0, false>(a, tp, bd, smem, device, st);
  else if (statics)
    err = a.radius == 1 ? launch<1, true>(a, tp, bd, smem, device, st)
                        : launch<2, true>(a, tp, bd, smem, device, st);
  else
    err = launch<0, true>(a, tp, bd, smem, device, st);
  const cudaError_t restored = cudaSetDevice(caller_device);
  if (err != cudaSuccess) return (int)err;
  return (int)restored;
}

}  // extern "C"
