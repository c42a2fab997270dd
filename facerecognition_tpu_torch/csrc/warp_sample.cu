// Two-pass separable warp and resize by direct sampling, for sm_90a.
//
// Replaces the XLA einsums of facerecognition_tpu/ops/warp_mxu.py
// (affine_warp_mxu_batch, bilinear_resize_mxu_batch, align_crop_mxu_batch,
// align_crop_mxu_window; not Pallas kernels). The TPU computes the warp as
// two dense interpolation-matrix products because it has no vector gather:
// pass 1 resamples every source column x at row Y(i, x) = aa i + bb x + cc
// (sheared per column), pass 2 resamples each output row at column
// x_s(i, j) = m00 j + m01 i + m02. Each matrix row has at most two nonzero
// weights, max(0, 1 - |pos - tap|), zeroed when pos lies outside
// [-1 + 1e-6, n - 1e-6]. Hopper gathers, so this kernel computes the same
// function directly: output (i, j) sums, over the two column taps of x_s in
// the sampled region, wx * mid(i, x), where mid(i, x) sums the two row taps of
// Y(i, x). Four source pixels per output pixel; no matrix is built.
//
// It computes that function, not an approximation of it: the sample
// positions use the plain version's roundings (a fused multiply-add where the
// plain version takes ops/umeyama.fma, separate rounding elsewhere; written
// with explicit __fmaf_rn / __fmul_rn / __fadd_rn, since nvcc would otherwise
// contract a * b + c). With `fast` the weights, the pixels and mid are rounded
// to bf16 (nearest even), as the plain version rounds its product operands;
// a product of two bf16 values is exact in float32, so each sum of two taps is
// rounded once, in any order, and the kernel gives the plain version's bits.
// Without `fast` the products round, and the plain version's matrix products
// may sum in another order: equal within float32 rounding. A NaN sample
// position gives zero weight here, where the matrix products give NaN.
//
// Per-slot inputs come from the plain version's own code (ops/warp_mxu.py):
// the six coefficients (m00, m01, m02, aa, bb, cc), and for each slot its
// frame and the origin of its sampled region (a crop window, zero outside;
// or the whole frame). A slot reads its frame in place, so the crowd path's
// M-fold frame repeat and its crops are never written. The resize is the
// same sampling with shared, edge-clamped positions from tables.
//
// What bounds it, on the H100 SXM's published 3.35 TB/s: bytes. Each output
// value costs about 12 float operations and reads four pixels, most of which
// neighbouring outputs read again through L1/L2; at the serving shapes the
// float32 output (B x 112 x 112 x 3) and the source pixels touched are the
// traffic. One thread computes the three channels of one output pixel, so a
// warp writes 384 contiguous bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int CHANNELS = 3;

// float -> bf16 -> float, round to nearest even, as torch's bfloat16 cast.
__device__ __forceinline__ float bf16_round(float x) {
  if (x != x) return x;
  const uint32_t b = __float_as_uint(x);
  return __uint_as_float((b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u);
}

// The weight of integer tap `tap` for a sample at `pos`: the plain version's
// clamp(1 - |pos - tap|, min=0), times 0 outside [lo, hi].
template <bool FAST>
__device__ __forceinline__ float tap_weight(float pos, int tap, float lo, float hi) {
  float w = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)tap))), 0.0f);
  if (!(pos >= lo && pos <= hi)) w = 0.0f;
  return FAST ? bf16_round(w) : w;
}

template <bool U8>
struct Pixels;

template <>
struct Pixels<true> {
  const uint8_t* p;
  __device__ __forceinline__ float at(size_t i) const { return (float)p[i]; }
};

template <>
struct Pixels<false> {
  const float* p;
  __device__ __forceinline__ float at(size_t i) const { return p[i]; }
};

struct Region {
  int frame, x0, y0;
};

// grid (slots, pixel blocks). TABLE: positions from ypos[i] / xpos[j] (the
// resize; slot s reads frame s whole). Otherwise from coef[s] and src[s].
template <bool U8, bool FAST, bool TABLE>
__global__ void __launch_bounds__(THREADS)
    warp_sample(Pixels<U8> img, int H, int W, const float* __restrict__ coef,
                const int* __restrict__ src, const float* __restrict__ ypos,
                const float* __restrict__ xpos, int reg_h, int reg_w, float lo, float hi_h,
                float hi_w, int out_h, int out_w, float* __restrict__ out) {
  const int s = blockIdx.x;
  const int p = blockIdx.y * THREADS + threadIdx.x;
  if (p >= out_h * out_w) return;
  const int i = p / out_w;
  const int j = p % out_w;
  const float fi = (float)i, fj = (float)j;

  Region r{s, 0, 0};
  float m00 = 0.f, m01 = 0.f, m02 = 0.f, aa = 0.f, bb = 0.f, cc = 0.f;
  float xs;
  if (TABLE) {
    xs = xpos[j];
  } else {
    const float* c = coef + (size_t)s * 6;
    m00 = c[0], m01 = c[1], m02 = c[2], aa = c[3], bb = c[4], cc = c[5];
    r = Region{src[3 * s], src[3 * s + 1], src[3 * s + 2]};
    xs = __fadd_rn(__fmaf_rn(m00, fj, __fmul_rn(m01, fi)), m02);
  }
  const size_t frame_base = (size_t)r.frame * H * W;

  float acc[CHANNELS] = {0.f, 0.f, 0.f};
  const int xf = (int)floorf(xs);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int x = xf + t;
    if (!(xs >= lo && xs <= hi_w) || x < 0 || x >= reg_w) continue;
    const float wx = tap_weight<FAST>(xs, x, lo, hi_w);
    const float Y =
        TABLE ? ypos[i] : __fadd_rn(__fmaf_rn(aa, fi, __fmul_rn(bb, (float)x)), cc);
    float mid[CHANNELS] = {0.f, 0.f, 0.f};
    if (Y >= lo && Y <= hi_h) {
      const int yf = (int)floorf(Y);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int y = yf + u;
        if (y < 0 || y >= reg_h) continue;
        const float wy = tap_weight<FAST>(Y, y, lo, hi_h);
        const size_t px = (frame_base + (size_t)(r.y0 + y) * W + (r.x0 + x)) * CHANNELS;
#pragma unroll
        for (int c = 0; c < CHANNELS; ++c) {
          const float v = FAST ? bf16_round(img.at(px + c)) : img.at(px + c);
          mid[c] = __fmaf_rn(wy, v, mid[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CHANNELS; ++c)
      acc[c] = __fmaf_rn(wx, FAST ? bf16_round(mid[c]) : mid[c], acc[c]);
  }
  float* o = out + ((size_t)s * out_h * out_w + p) * CHANNELS;
#pragma unroll
  for (int c = 0; c < CHANNELS; ++c) o[c] = acc[c];
}

template <bool U8, bool FAST, bool TABLE>
void launch(const void* frames, int H, int W, const float* coef, const int* src,
            const float* ypos, const float* xpos, int S, int reg_h, int reg_w, float lo,
            float hi_h, float hi_w, int out_h, int out_w, float* out, cudaStream_t st) {
  const dim3 grid(S, (out_h * out_w + THREADS - 1) / THREADS);
  Pixels<U8> img{static_cast<decltype(Pixels<U8>::p)>(frames)};
  warp_sample<U8, FAST, TABLE><<<grid, THREADS, 0, st>>>(img, H, W, coef, src, ypos, xpos, reg_h,
                                                         reg_w, lo, hi_h, hi_w, out_h, out_w, out);
}

}  // namespace

extern "C" {

// frames (F, H, W, 3) uint8 (frames_u8 = 1) or float32, row-major. Slot s
// writes out[s] (out_h, out_w, 3) float32. Affine mode (ypos == xpos ==
// nullptr): coef (S, 6) float32 and src (S, 3) int32 (frame, x0, y0); the slot
// samples the (reg_h, reg_w) region at (y0, x0) of its frame, zero outside
// it. Table mode (coef == src == nullptr): slot s resizes frame s, sampling
// rows ypos (out_h) and columns xpos (out_w) of the whole frame. lo, hi_h,
// hi_w are the float32 bounds of a sample position. Returns 0, a CUDA error
// code, or -1 for arguments it cannot run.
int warp_sample_launch(const void* frames, int frames_u8, int H, int W, const float* coef,
                       const int* src, const float* ypos, const float* xpos, int S, int reg_h,
                       int reg_w, float lo, float hi_h, float hi_w, int out_h, int out_w, int fast,
                       float* out, int device, void* stream) {
  const bool table = ypos != nullptr;
  if (frames == nullptr || out == nullptr || S < 1 || H < 1 || W < 1 || out_h < 1 ||
      out_w < 1 || reg_h < 1 || reg_w < 1 || reg_h > H || reg_w > W ||
      (long long)out_h * out_w > (long long)THREADS * 65535 ||
      (table ? (xpos == nullptr || coef != nullptr || src != nullptr)
             : (coef == nullptr || src == nullptr || xpos != nullptr)))
    return -1;
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
#define WARP_SAMPLE_LAUNCH(U8, FAST, TABLE) \
  launch<U8, FAST, TABLE>(frames, H, W, coef, src, ypos, xpos, S, reg_h, reg_w, lo, hi_h, hi_w, \
                          out_h, out_w, out, st)
  const int mode = (frames_u8 ? 4 : 0) | (fast ? 2 : 0) | (table ? 1 : 0);
  switch (mode) {
    case 0: WARP_SAMPLE_LAUNCH(false, false, false); break;
    case 1: WARP_SAMPLE_LAUNCH(false, false, true); break;
    case 2: WARP_SAMPLE_LAUNCH(false, true, false); break;
    case 3: WARP_SAMPLE_LAUNCH(false, true, true); break;
    case 4: WARP_SAMPLE_LAUNCH(true, false, false); break;
    case 5: WARP_SAMPLE_LAUNCH(true, false, true); break;
    case 6: WARP_SAMPLE_LAUNCH(true, true, false); break;
    default: WARP_SAMPLE_LAUNCH(true, true, true); break;
  }
#undef WARP_SAMPLE_LAUNCH
  err = cudaGetLastError();
  const cudaError_t restored = cudaSetDevice(caller_device);
  if (err != cudaSuccess) return (int)err;
  return (int)restored;
}

}  // extern "C"
