// LBPH features: circular LBP codes and cell histograms, for sm_90a.
//
// Replaces the XLA graph of facerecognition_tpu/models/lbph.py lbph_features
// (lbp_code_image + spatial_histogram; not a Pallas kernel), vmapped over a
// batch of gray images. Its plain PyTorch version is
// ops/lbph_hist.lbph_features_plain.
//
// One block per (cell, image). Each thread takes pixels of the cell in
// turn: it computes the pixel's code in registers, P neighbours of four
// bilinear taps each, and adds one to the code's bin of the cell's histogram
// in shared memory (atomicAdd); after a barrier the block writes each bin
// once, its count times float32(1 / pixels of a cell). Above 8192 bins
// (neighbours 14-16) the histogram is the output row itself: zeroed,
// counted with float atomics (exact below 2^24) and scaled in place.
//
// The codes are JAX's bits. A neighbour's tap sum w1*a + w2*b + w3*c + w4*d
// can miss the centre of a flat region by 1e-5 at 200, far above the bit
// test's eps, so the bit depends on how the sum rounds. The host passes the
// plan of XLA's CPU graph (ops/lbph_hist.tap_plan) as a small device array:
// per neighbour the taps' offsets, float32 weights and, per step, whether
// the next term is added as a rounded product or fused into an fma. A block
// copies it to shared memory, where every thread reads the same word. The
// arithmetic is written with explicit roundings (__fmul_rn, __fadd_rn,
// __fmaf_rn) so nvcc contracts nothing else; the file is built without fast
// math.
//
// What bounds it: bytes. Each image is read once (40 KB at 100x100) and its
// histograms written once (64 KB at 8x8 cells of 256 bins): 13.4 MB for 128
// images, about 4 us at 3.35 TB/s. The taps (32 loads a pixel at P = 8) are
// served by L1; the atomics of a cell's 144 pixels land in shared memory.

#include <cuda_runtime.h>

#include <cfloat>

// Mirrors ops/lbph_hist._Args field for field (outside the unnamed namespace:
// the C launcher takes it).
struct LbphArgs {
  const float* images;  // (B, H, W) float32
  const int* plan;      // (neighbors, PLAN_WORDS) int32, see ops/lbph_hist.plan_words
  float* out;           // (B, grid_y * grid_x * 2^P) float32
  int B, H, W, radius, neighbors, grid_x, grid_y, cell_h, cell_w;
  float inv_cell;
};

namespace {

constexpr int MAX_NEIGHBORS = 16;
constexpr int THREADS = 256;
constexpr int MAX_SMEM_BINS = 8192;  // 32 KB of int counts
constexpr int ADD = 0, FMA_LEFT = 1;  // FMA_RIGHT = 2: the step's default

// One neighbour's words of the plan: dy[4], dx[4], the weights' float32
// bits[4], op[3] (how steps 0-2 join the next term) and a pad.
constexpr int PLAN_WORDS = 16;
constexpr int DY = 0, DX = 4, WT = 8, OP = 12;

__device__ __forceinline__ int lbp_code(const LbphArgs& a, const int* plan, const float* img,
                                        int i, int j) {
  const float c = img[i * a.W + j];
  int code = 0;
  for (int n = 0; n < a.neighbors; ++n) {
    const int* q = plan + n * PLAN_WORDS;
    float v[4], w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = img[(i + q[DY + k]) * a.W + j + q[DX + k]];
      w[k] = __int_as_float(q[WT + k]);
    }
    float t;
    if (q[OP] == ADD) {
      t = __fadd_rn(__fmul_rn(v[0], w[0]), __fmul_rn(v[1], w[1]));
    } else if (q[OP] == FMA_LEFT) {
      t = __fmaf_rn(v[0], w[0], __fmul_rn(v[1], w[1]));
    } else {
      t = __fmaf_rn(v[1], w[1], __fmul_rn(v[0], w[0]));
    }
#pragma unroll
    for (int k = 2; k < 4; ++k) {
      t = q[OP + k - 1] == ADD ? __fadd_rn(t, __fmul_rn(v[k], w[k])) : __fmaf_rn(v[k], w[k], t);
    }
    const bool bit = t > c || fabsf(__fsub_rn(t, c)) < FLT_EPSILON;
    code |= (int)bit << n;
  }
  return code;
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS) lbph_hist(const LbphArgs a) {
  extern __shared__ int hist[];
  __shared__ int plan[MAX_NEIGHBORS * PLAN_WORDS];
  const int cell = blockIdx.x;
  const int image = blockIdx.y;
  const int bins = 1 << a.neighbors;
  const int cells = a.grid_x * a.grid_y;
  const int row0 = (cell / a.grid_x) * a.cell_h + a.radius;
  const int col0 = (cell % a.grid_x) * a.cell_w + a.radius;
  const float* img = a.images + (size_t)image * a.H * a.W;
  float* out = a.out + ((size_t)image * cells + cell) * bins;
  for (int k = threadIdx.x; k < a.neighbors * PLAN_WORDS; k += THREADS) plan[k] = a.plan[k];
  for (int b = threadIdx.x; b < bins; b += THREADS) {
    if (SMEM) hist[b] = 0;
    else out[b] = 0.0f;
  }
  __syncthreads();
  const int pixels = a.cell_h * a.cell_w;
  for (int p = threadIdx.x; p < pixels; p += THREADS) {
    const int code = lbp_code(a, plan, img, row0 + p / a.cell_w, col0 + p % a.cell_w);
    if (SMEM) atomicAdd(&hist[code], 1);
    else atomicAdd(&out[code], 1.0f);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += THREADS) {
    // the float path's counts were added at L2: read them past L1
    const float count = SMEM ? (float)hist[b] : __ldcg(&out[b]);
    out[b] = __fmul_rn(count, a.inv_cell);
  }
}

}  // namespace

extern "C" {

// See LbphArgs. Returns 0, a CUDA error code, or -1 for arguments it cannot run.
int lbph_hist_launch(const LbphArgs* a, int device, void* stream) {
  if (a->B < 1 || a->neighbors < 1 || a->neighbors > MAX_NEIGHBORS || a->radius < 1 ||
      a->cell_h < 1 || a->cell_w < 1 || a->grid_x < 1 || a->grid_y < 1 ||
      a->grid_y * a->cell_h > a->H - 2 * a->radius ||
      a->grid_x * a->cell_w > a->W - 2 * a->radius || a->B > 65535)
    return -1;
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(a->grid_x * a->grid_y, a->B);
  const int bins = 1 << a->neighbors;
  if (bins <= MAX_SMEM_BINS) {
    lbph_hist<true><<<grid, THREADS, bins * sizeof(int), st>>>(*a);
  } else {
    lbph_hist<false><<<grid, THREADS, 0, st>>>(*a);
  }
  err = cudaGetLastError();
  const cudaError_t restored = cudaSetDevice(caller_device);
  if (err != cudaSuccess) return (int)err;
  return (int)restored;
}

}  // extern "C"
