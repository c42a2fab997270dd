// The serving path's preprocessing warp, for sm_90a: the detector's resized
// input and the embedder's aligned input, normalised, in one launch each.
//
// Replaces the XLA einsums of facerecognition_tpu/ops/warp_mxu.py
// (affine_warp_mxu_batch, bilinear_resize_mxu_batch, align_crop_mxu_batch,
// align_crop_mxu_window; not Pallas kernels) and, around them in the fused
// serving graph, the landmark scale and clamp, the Umeyama solve, the inverse
// map, the crowd window and the input normalisation. Training's augmentation
// (data/augment.py) calls the matrix mode: each slot's forward map is given,
// and the launch inverts it. The TPU computes the
// warp as two dense interpolation-matrix products because it has no vector
// gather: pass 1 resamples every source column x at row Y(i, x) = aa i +
// bb x + cc (sheared per column), pass 2 resamples each output row at column
// x_s(i, j) = m00 j + m01 i + m02. Each matrix row has at most two nonzero
// weights, max(0, 1 - |pos - tap|), zeroed when pos lies outside
// [-1 + 1e-6, n - 1e-6]. Hopper gathers, so this kernel computes the same
// function directly: output (i, j) sums, over the two column taps of x_s in
// the sampled region, wx * mid(i, x), where mid(i, x) sums the two row taps
// of Y(i, x). Four source pixels per output pixel; no matrix is built.
//
// It computes that function, not an approximation of it. Each block computes
// its slot's parameters from the raw landmarks, in the plain version's order
// of operations (ops/umeyama.py, ops/warp_mxu.py): scale and clamp, the
// Umeyama closed form with its sums left to right, invert_affine's LU solve
// with the |det| <= 1e-8 guard, warp_coefficients' m00 guard, and for the
// crowd window the origin (rounded half to even, clamped into the frame) and
// the cropped map. Each operation is written with explicit rounding
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn; nvcc would otherwise
// contract a * b + c), and ops/umeyama.fma, a float64 product and sum rounded
// to float32, as exactly that (fma64), in the solve and in the per-pixel
// positions. With `fast` the weights, the pixels and mid are rounded to bf16
// (nearest even), as the plain version rounds its product operands; a
// product of two bf16 values is exact in float32, so each sum of two taps is
// rounded once, in any order, and the kernel gives the plain version's bits.
// Without `fast` the products round, and the plain version's matrix products
// may sum in another order: equal within float32 rounding. The int8 mode
// (fast = 2, JAX's fast="int8"; not for the resize, where JAX takes "int8" as
// a true value and the wrapper passes 1) quantises each tap's weight to
// rint(w * 127) and each pixel to clip(rint(p), 0, 255); every sum is then an
// integer below 2^24, exact in float32 in any order. Each vertical sample is
// 127 x the mid pixel: it is rounded to the pixel (a product with
// float32(1/127), rint, clip) before the horizontal blend, as the plain
// version's pass 1 rounds, and the blend ends with the same product, so the
// kernel gives the plain version's bits. A NaN sample
// position gives zero weight here, where the matrix products give NaN. The
// normalisation is the one PyTorch runs on the card: a division by a Python
// number is a product with its float32 reciprocal.
//
// What bounds it, on the H100 SXM's published 3.35 TB/s: bytes, the float32
// output (S x 3 x out_h x out_w) and the uint8 source pixels the taps reach.
// What held the first version (one thread a pixel, its parameters from a
// PyTorch prologue) back was the host: 250-400 small operations a call; and
// inside the kernel, instructions: twelve one-byte loads and conversions per
// pixel. The design:
//   - one launch a call: the per-slot solve (a few hundred dependent
//     operations) runs in thread 0 of each block, once for the block's
//     several consecutive tiles of the slot;
//   - each block stages the uint8 footprint of a tile of its slot's output
//     (about 28 x 28 at 112^2) in shared memory with coalesced 16-byte
//     cp.async copies, two buffers deep: tile k + 1 is copied while tile k is
//     sampled. A footprint above the buffer (or frames whose rows are not
//     16-byte aligned, or float32 frames) is read from global memory on a
//     path of its own;
//   - the sampling from the stage is branch-free: a tap outside the region is
//     read at a harmless offset and dropped by a select; a pixel's three
//     bytes are two aligned words, a funnel shift and byte permutes; floors
//     and byte-to-float conversions are float adds, not conversions (a
//     quarter of the float rate on this card); bf16 rounding is one
//     conversion instruction;
//   - each thread computes four neighbouring output pixels of one row and
//     writes each channel plane with one 16-byte store: the output is planar
//     NCHW, what the convolutions read, normalised already;
//   - the output is in the model's compute dtype (`out_dtype`: float32,
//     bf16 or fp16): each float32 value is rounded once to it, to nearest
//     even (__float2bfloat16_rn / __float2half_rn), as it is stored, which is
//     JAX's x.astype(dtype) at the model's entry, so no cast follows the
//     warp and the output's bytes halve (one 8-byte store per plane).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

// The `fast` modes: float32, bf16 operands, int8 operands.
enum { F32 = 0, BF16 = 1, INT8 = 2 };
// The output dtypes (`out_dtype`).
enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_F16 = 2 };

// Mirrored field for field by ops/warp_sample._Args (ctypes). Outside the
// anonymous namespace: warp_sample_launch, which takes it, keeps C linkage.
struct WarpArgs {
  const void* frames;      // (F, H, W, 3) uint8 or float32
  const float* landmarks;  // (S, 5, 2); null: resize, slot s reads frame s
  void* out;               // (S, 3, out_h, out_w) in out_dtype
  float* slot_params;      // optional (S, 8): m00 m01 m02 aa bb cc x0 y0
  const float* matrices;   // (S, 2, 3) forward maps in place of landmarks; else null
  int frames_u8, n_frames, H, W;
  int slots, per_frame;    // slot s reads frame s / per_frame
  int out_h, out_w;
  int window;              // crop side (already min(window, H, W)); 0: whole frame
  int fast, normalize;     // fast: F32, BF16 or INT8
  int out_dtype;           // OUT_F32, OUT_BF16 or OUT_F16
  float lm_scale_x, lm_scale_y, lm_min, lm_max_x, lm_max_y;
  float tmpl[10];          // the template scaled to out_size, (x, y) per point
  float norm_mul, norm_sub, norm_scale;  // ((v * mul) - sub) * scale
  float lo, hi_h, hi_w;    // the float32 bounds of a sample position
  float ratio_y, ratio_x;  // resize: n_src / n_dst
};

namespace {

using Args = WarpArgs;

constexpr int CH = 3;
constexpr int MAX_THREADS = 256;
constexpr int MAX_GROUPS = 8;  // four-pixel groups per tile row
constexpr int STAGE_BYTES = 24000;  // per buffer; two buffers per block (48 KB static)
constexpr int STAGE_PAD = 16;  // stage_pixel reads up to 7 bytes past a pixel

struct Tiling {
  int groups;   // four-pixel groups per tile row
  int tile_w, tile_h, tiles_x;
  int tiles, per_block;  // tiles of a slot; consecutive tiles one block takes
  int vec;      // out_w % 4 == 0: 16-byte stores
  int stage_ok; // uint8 frames with 16-byte aligned rows
};

struct Slot {
  float m00, m01, m02, aa, bb, cc;
  int frame, x0, y0, reg_h, reg_w;
};

struct Footprint {
  int use;                 // staged in shared memory
  int ylo, yhi;            // staged region rows, inclusive
  int gstart, pitch;       // byte offset of the staged row segment; row pitch
};

// float -> bf16 -> float, round to nearest even, as torch's bfloat16 cast.
__device__ __forceinline__ float bf16_round(float x) {
  if (x != x) return x;
  const uint32_t b = __float_as_uint(x);
  return __uint_as_float((b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u);
}

// The same rounding for a finite x, in one conversion instruction.
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ops/umeyama.fma: a * b + c in float64 (the product is exact), rounded to
// float32. Not __fmaf_rn: the float64 sum may round first.
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// torch.maximum / minimum / clamp: NaN in, NaN out.
__device__ __forceinline__ float nmax(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}

__device__ __forceinline__ float sum5(const float* v) {
  float s = v[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) s = __fadd_rn(s, v[k]);
  return s;
}

// ops/umeyama.umeyama_batch for one slot: src (5, 2) onto dst (5, 2) ->
// m = [[l00, l01, t0], [l10, l11, t1]].
__device__ void umeyama(const float* src, const float* dst, float* m) {
  float sx[5], sy[5], dx[5], dy[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) sx[k] = src[2 * k], sy[k] = src[2 * k + 1];
#pragma unroll
  for (int k = 0; k < 5; ++k) dx[k] = dst[2 * k], dy[k] = dst[2 * k + 1];
  const float mu_sx = __fdiv_rn(sum5(sx), 5.0f), mu_sy = __fdiv_rn(sum5(sy), 5.0f);
  const float mu_dx = __fdiv_rn(sum5(dx), 5.0f), mu_dy = __fdiv_rn(sum5(dy), 5.0f);
  float scx[5], scy[5], dcx[5], dcy[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    scx[k] = __fsub_rn(sx[k], mu_sx), scy[k] = __fsub_rn(sy[k], mu_sy);
    dcx[k] = __fsub_rn(dx[k], mu_dx), dcy[k] = __fsub_rn(dy[k], mu_dy);
  }
  float p[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) p[k] = __fmul_rn(dcx[k], scx[k]);
  const float a = __fdiv_rn(sum5(p), 5.0f);
#pragma unroll
  for (int k = 0; k < 5; ++k) p[k] = __fmul_rn(dcx[k], scy[k]);
  const float b = __fdiv_rn(sum5(p), 5.0f);
#pragma unroll
  for (int k = 0; k < 5; ++k) p[k] = __fmul_rn(dcy[k], scx[k]);
  const float c = __fdiv_rn(sum5(p), 5.0f);
#pragma unroll
  for (int k = 0; k < 5; ++k) p[k] = __fmul_rn(dcy[k], scy[k]);
  const float d = __fdiv_rn(sum5(p), 5.0f);
  const float cs = __fadd_rn(a, d), sn = __fsub_rn(c, b);
  const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(cs, cs), __fmul_rn(sn, sn)));
  const bool degenerate = r == 0.0f;
  const float cosv = degenerate ? 1.0f : __fdiv_rn(cs, r);
  const float sinv = degenerate ? 0.0f : __fdiv_rn(sn, r);
#pragma unroll
  for (int k = 0; k < 5; ++k) p[k] = __fadd_rn(__fmul_rn(scx[k], scx[k]), __fmul_rn(scy[k], scy[k]));
  const float var_src = __fdiv_rn(sum5(p), 5.0f);
  const float scale = __fdiv_rn(r, nmax(var_src, 1e-12f));
  const float l00 = __fmul_rn(scale, cosv), l01 = __fmul_rn(scale, -sinv);
  const float l10 = __fmul_rn(scale, sinv), l11 = __fmul_rn(scale, cosv);
  m[0] = l00, m[1] = l01;
  m[2] = __fsub_rn(mu_dx, __fadd_rn(__fmul_rn(l00, mu_sx), __fmul_rn(l01, mu_sy)));
  m[3] = l10, m[4] = l11;
  m[5] = __fsub_rn(mu_dy, __fadd_rn(__fmul_rn(l10, mu_sx), __fmul_rn(l11, mu_sy)));
}

// ops/umeyama.invert_affine: the LU solve with partial pivoting, reciprocal
// pivots and fma where the plain version takes one.
__device__ void invert_affine(const float* m, float* inv) {
  float a = m[0], b = m[1], c = m[3], d = m[4];
  const float tx = m[2], ty = m[5];
  const bool ok = fabsf(__fsub_rn(__fmul_rn(a, d), __fmul_rn(b, c))) > 1e-8f;
  if (!ok) a = 1.0f, b = 0.0f, c = 0.0f, d = 1.0f;
  const bool swap = fabsf(c) > fabsf(a);
  const float p00 = swap ? c : a, p01 = swap ? d : b;
  const float p10 = swap ? a : c, p11 = swap ? b : d;
  const float r00 = __fdiv_rn(1.0f, p00);
  const float low = __fmul_rn(p10, r00);
  const float r11 = __fdiv_rn(1.0f, __fsub_rn(p11, __fmul_rn(low, p01)));
  const float x1_low = __fmul_rn(-low, r11);
  const float x1_c0 = swap ? r11 : x1_low;
  const float x1_c1 = swap ? x1_low : r11;
  const float one_c0 = __fmul_rn(fma64(-p01, x1_c0, 1.0f), r00);
  const float zero_c0 = __fmul_rn(__fmul_rn(-p01, x1_c0), r00);
  const float one_c1 = __fmul_rn(fma64(-p01, x1_c1, 1.0f), r00);
  const float zero_c1 = __fmul_rn(__fmul_rn(-p01, x1_c1), r00);
  const float ia = swap ? zero_c0 : one_c0, ib = swap ? one_c1 : zero_c1;
  const float ic = x1_c0, id = x1_c1;
  inv[0] = ia, inv[1] = ib, inv[2] = -fma64(ib, ty, __fmul_rn(ia, tx));
  inv[3] = ic, inv[4] = id, inv[5] = -fma64(id, ty, __fmul_rn(ic, tx));
}

// ops/warp_mxu.warp_coefficients of one inverse map.
__device__ void coefficients(const float* inv, Slot& sl) {
  const float m00 = inv[0], m01 = inv[1], m02 = inv[2];
  const float m10 = inv[3], m11 = inv[4], m12 = inv[5];
  const float tiny = m00 < 0.0f ? -1e-6f : 1e-6f;
  const float m00_safe = fabsf(m00) < 1e-6f ? tiny : m00;
  const float bb = __fdiv_rn(m10, m00_safe);
  sl.m00 = m00, sl.m01 = m01, sl.m02 = m02;
  sl.aa = fma64(-bb, m01, m11);
  sl.bb = bb;
  sl.cc = fma64(-bb, m02, m12);
}

__device__ __forceinline__ int clamp_origin(float v, int hi) {
  const long long o = (long long)v;  // torch's .long() on the card
  return (int)(o < 0 ? 0 : o > hi ? hi : o);
}

// One slot's parameters (thread 0 of each of its blocks).
__device__ void slot_prologue(const Args& a, int s, Slot& sl) {
  sl.frame = s / a.per_frame;
  sl.x0 = 0, sl.y0 = 0, sl.reg_h = a.H, sl.reg_w = a.W;
  if (a.matrices != nullptr) {
    // ops/warp_mxu.affine_warp_mxu_batch: the forward map as it is given,
    // its inverse and coefficients (no landmarks, no window).
    float ms[6], inv[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) ms[k] = a.matrices[(size_t)s * 6 + k];
    invert_affine(ms, inv);
    coefficients(inv, sl);
    return;
  }
  float lm[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const bool x = (k & 1) == 0;
    const float v = __fmul_rn(a.landmarks[(size_t)s * 10 + k], x ? a.lm_scale_x : a.lm_scale_y);
    lm[k] = nmin(nmax(v, a.lm_min), x ? a.lm_max_x : a.lm_max_y);
  }
  float ms[6], inv[6];
  umeyama(lm, a.tmpl, ms);
  if (a.window > 0) {
    // ops/warp_mxu.window_origin
    invert_affine(ms, inv);
    const float c = (float)(a.out_h - 1) / 2.0f;  // out_h == out_w here
    const float half = (float)(a.window - 1) / 2.0f;
    const float cx = __fadd_rn(__fadd_rn(__fmul_rn(inv[0], c), __fmul_rn(inv[1], c)), inv[2]);
    const float cy = __fadd_rn(__fadd_rn(__fmul_rn(inv[3], c), __fmul_rn(inv[4], c)), inv[5]);
    sl.x0 = clamp_origin(rintf(__fsub_rn(cx, half)), a.W - a.window);
    sl.y0 = clamp_origin(rintf(__fsub_rn(cy, half)), a.H - a.window);
    sl.reg_h = sl.reg_w = a.window;
    const float ox = (float)sl.x0, oy = (float)sl.y0;
    ms[2] = __fadd_rn(ms[2], __fadd_rn(__fmul_rn(ms[0], ox), __fmul_rn(ms[1], oy)));
    ms[5] = __fadd_rn(ms[5], __fadd_rn(__fmul_rn(ms[3], ox), __fmul_rn(ms[4], oy)));
  }
  invert_affine(ms, inv);
  coefficients(inv, sl);
}

// ops/warp_mxu.resize_positions at index k.
__device__ __forceinline__ float resize_pos(int k, float ratio, int n_src) {
  const float p = __fsub_rn(__fmul_rn(__fadd_rn((float)k, 0.5f), ratio), 0.5f);
  return fminf(fmaxf(p, 0.0f), (float)(n_src - 1));
}

// The source rows and columns (region coordinates) the taps of output rows
// [ia, ib] x columns [ja, jb] can reach, with a pixel of margin for rounding;
// staged when they fit the budget. Every valid tap of the tile lies in the
// box: the positions are linear in (i, j) and in (i, x), so their extremes
// are at the corners, and the corners here differ from the sampled
// positions by their rounding, well under the margin.
template <bool RESIZE>
__device__ void footprint(const Args& a, const Tiling& tl, const Slot& sl, int ia, int ib, int ja,
                          int jb, Footprint& fp) {
  fp.use = 0;
  if (!tl.stage_ok) return;
  float xmin, xmax, ymin, ymax;
  if (RESIZE) {
    xmin = resize_pos(ja, a.ratio_x, a.W), xmax = resize_pos(jb, a.ratio_x, a.W);
    ymin = resize_pos(ia, a.ratio_y, a.H), ymax = resize_pos(ib, a.ratio_y, a.H);
  } else {
    // Positions are bounded by their corners only up to their rounding:
    // below 2^16 px in every term it is far under a pixel, and the margin
    // below covers it. A larger map reads from global memory.
    const float bx = fabsf(sl.m00) * a.out_w + fabsf(sl.m01) * a.out_h + fabsf(sl.m02);
    const float by = fabsf(sl.aa) * a.out_h + fabsf(sl.bb) * (sl.reg_w + 2) + fabsf(sl.cc);
    if (!(bx <= 65536.0f && by <= 65536.0f)) return;  // also NaN
    const float fi[2] = {(float)ia, (float)ib}, fj[2] = {(float)ja, (float)jb};
    xmin = INFINITY, xmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float x = sl.m00 * fj[v] + sl.m01 * fi[u] + sl.m02;
        xmin = fminf(xmin, x), xmax = fmaxf(xmax, x);
      }
    if (!(xmin >= -1e6f && xmax <= 1e6f)) return;  // also NaN
    const float xl = fmaxf(floorf(xmin) - 1.0f, 0.0f);
    const float xh = fminf(floorf(xmax) + 2.0f, (float)(sl.reg_w - 1));
    ymin = INFINITY, ymax = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float y0 = sl.aa * fi[u] + sl.bb * xl + sl.cc;
      const float y1 = sl.aa * fi[u] + sl.bb * xh + sl.cc;
      ymin = fminf(ymin, fminf(y0, y1)), ymax = fmaxf(ymax, fmaxf(y0, y1));
    }
    if (!(ymin >= -1e6f && ymax <= 1e6f)) return;
  }
  const float xl = fmaxf(floorf(xmin) - 1.0f, 0.0f);
  const float xh = fminf(floorf(xmax) + 2.0f, (float)(sl.reg_w - 1));
  const float yl = fmaxf(floorf(ymin) - 1.0f, 0.0f);
  const float yh = fminf(floorf(ymax) + 2.0f, (float)(sl.reg_h - 1));
  if (!(xl <= xh && yl <= yh)) return;  // every tap lies outside the region
  fp.ylo = (int)yl, fp.yhi = (int)yh;
  fp.gstart = ((sl.x0 + (int)xl) * CH) & ~15;
  const int end = ((sl.x0 + (int)xh + 1) * CH + 15) & ~15;  // <= W * 3: rows are 16-byte multiples
  fp.pitch = end - fp.gstart;
  fp.use = (fp.yhi - fp.ylo + 1) * fp.pitch <= STAGE_BYTES;
}

// Conversions run at a quarter of the float32 rate on this card; the
// sampling loop does without them. u8f: a byte as a float (2^23 + v - 2^23,
// exact). floor_small: floor(x) as a float and an int for |x| < 2^22 (the
// sample positions, checked against their bounds first): adding 1.5 * 2^23
// rounds x to an integer held in the low mantissa bits.
__device__ __forceinline__ float u8f(unsigned v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}
__device__ __forceinline__ float floor_small(float x, int& xi) {
  const float t = __fadd_rn(x, 12582912.0f);
  float r = __fsub_rn(t, 12582912.0f);
  int i = __float_as_int(t) - 0x4B400000;
  if (r > x) r = __fsub_rn(r, 1.0f), --i;
  xi = i;
  return r;
}
// The three channel bytes at byte offset o of the stage: two aligned words,
// a funnel shift, and each byte placed under the exponent of 2^23.
__device__ __forceinline__ void stage_pixel(const unsigned char* stage, int o, float* v) {
  const unsigned* w = reinterpret_cast<const unsigned*>(stage + (o & ~3));
  const unsigned px = __funnelshift_r(w[0], w[1], 8 * (o & 3));
#pragma unroll
  for (int c = 0; c < CH; ++c)
    v[c] = __fsub_rn(__uint_as_float(__byte_perm(px, 0x4B000000u, c | 0x7440)), 8388608.0f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// float32(1 / 127): XLA's division by 127 in the int8 mode.
constexpr float R127 = 1.0f / 127.0f;

// The plain version's clamp(1 - |pos - tap|, min=0), as the mode rounds it.
// Its zero outside [lo, hi] is the callers': they skip such a position
// altogether.
template <int MODE>
__device__ __forceinline__ float tap_weight(float pos, float tap) {
  const float w = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, tap))), 0.0f);
  return MODE == BF16 ? bf16_rn(w) : MODE == INT8 ? rintf(__fmul_rn(w, 127.0f)) : w;
}

// The int8 mode's rounding of a level: rint, clip to [0, 255].
__device__ __forceinline__ float level(float v) { return fminf(fmaxf(rintf(v), 0.0f), 255.0f); }

// A vertical sample as the horizontal blend takes it.
template <int MODE, bool FINITE>
__device__ __forceinline__ float mid_operand(float m) {
  return MODE == BF16 ? (FINITE ? bf16_rn(m) : bf16_round(m))
         : MODE == INT8 ? level(__fmul_rn(m, R127)) : m;
}

// Thread 0 of a block: its slot's parameters, once per block.
template <bool RESIZE>
__device__ void block_slot(const Args& a, int s, Slot& sl) {
  if (RESIZE) {
    sl = Slot{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, s, 0, 0, a.H, a.W};
    return;
  }
  slot_prologue(a, s, sl);
  if (a.slot_params != nullptr && blockIdx.y == 0) {
    float* p = a.slot_params + (size_t)s * 8;
    p[0] = sl.m00, p[1] = sl.m01, p[2] = sl.m02, p[3] = sl.aa, p[4] = sl.bb, p[5] = sl.cc;
    p[6] = (float)sl.x0, p[7] = (float)sl.y0;
  }
}

struct Rect {
  int ia, ib, ja, jb;  // output rows and columns, inclusive
};

__device__ __forceinline__ Rect tile_rect(const Args& a, const Tiling& tl, int q) {
  const int ty = q / tl.tiles_x, tx = q % tl.tiles_x;
  const int ia = ty * tl.tile_h, ja = tx * tl.tile_w;
  return Rect{ia, min(a.out_h, ia + tl.tile_h) - 1, ja, min(a.out_w, ja + tl.tile_w) - 1};
}

// Every thread's share of a tile's footprint, as 16-byte cp.async copies
// into `buf`, then one commit (an empty group when nothing is staged).
__device__ __forceinline__ void stage_tile(const Args& a, const Slot& sl, const Footprint& fp,
                                           unsigned char* buf) {
  if (fp.use) {
    const size_t row_bytes = (size_t)a.W * CH;
    const size_t row0 = (size_t)sl.frame * a.H + sl.y0 + fp.ylo;
    const int per_row = fp.pitch / 16;
    const int chunks = (fp.yhi - fp.ylo + 1) * per_row;
    const unsigned char* src = static_cast<const unsigned char*>(a.frames);
    for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
      const int r = q / per_row, k = q % per_row;
      cp_async16(buf + r * fp.pitch + 16 * k, src + (row0 + r) * row_bytes + fp.gstart + 16 * k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The taps of four output pixels read from global memory, with every check
// as a branch: float32 frames, and uint8 tiles not staged (a footprint above
// the budget, rows not 16-byte aligned, or a map too large to bound).
template <bool U8, int MODE, bool RESIZE>
__device__ void sample_global(const Args& a, const Slot& sl, int i, int j0, int jb,
                              float (&res)[CH][4]) {
  const float fi = (float)i;
  const size_t row_bytes = (size_t)a.W * CH;
  const size_t frame_row0 = (size_t)sl.frame * a.H + sl.y0;  // global row of region row 0
  auto fetch = [&](int y, int x, float* v) {
    const size_t px = (frame_row0 + y) * row_bytes + (size_t)(sl.x0 + x) * CH;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      v[c] = U8 ? u8f(static_cast<const unsigned char*>(a.frames)[px + c])
                : static_cast<const float*>(a.frames)[px + c];
  };
  // mid(i, x): the two row taps of Y at column x, in order
  auto column = [&](int x, float Y, float yf, int yi, float* mid) {
#pragma unroll
    for (int c = 0; c < CH; ++c) mid[c] = 0.0f;
    if (!(Y >= a.lo && Y <= a.hi_h)) return;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int y = yi + u;
      if (y < 0 || y >= sl.reg_h) continue;
      const float wy = tap_weight<MODE>(Y, __fadd_rn(yf, (float)u));
      float v[CH];
      fetch(y, x, v);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        mid[c] = __fmaf_rn(
            wy, U8 ? v[c] : MODE == BF16 ? bf16_round(v[c]) : MODE == INT8 ? level(v[c]) : v[c],
            mid[c]);
    }
  };

  // The resize's row position is the same for every tap of the row.
  float row_y = 0.0f, row_yf = 0.0f;
  int row_yi = 0;
  double m01i = 0.0, aai = 0.0;
  const double jd0 = (double)j0;
  if (RESIZE) {
    row_y = resize_pos(i, a.ratio_y, a.H);
    row_yf = floor_small(row_y, row_yi);
  } else {
    m01i = (double)__fmul_rn(sl.m01, fi);        // the float32 product m01 * i
    aai = __dmul_rn((double)sl.aa, (double)fi);  // exact
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int j = j0 + p;
    float acc[CH] = {0.f, 0.f, 0.f};
    const float xs =
        RESIZE ? resize_pos(j, a.ratio_x, a.W)
               : __fadd_rn(__double2float_rn(__dadd_rn(
                               __dmul_rn((double)sl.m00, __dadd_rn(jd0, (double)p)), m01i)),
                           sl.m02);
    if (j <= jb && xs >= a.lo && xs <= a.hi_w) {
      int xi;
      const float xf = floor_small(xs, xi);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int x = xi + t;
        if (x < 0 || x >= sl.reg_w) continue;
        const float xt = __fadd_rn(xf, (float)t);
        const float wx = tap_weight<MODE>(xs, xt);
        float mid[CH];
        if (RESIZE) {
          column(x, row_y, row_yf, row_yi, mid);
        } else {
          const float Y =
              __fadd_rn(__double2float_rn(__dadd_rn(aai, (double)__fmul_rn(sl.bb, xt))), sl.cc);
          int yi = 0;
          const float yf = (Y >= a.lo && Y <= a.hi_h) ? floor_small(Y, yi) : 0.0f;
          column(x, Y, yf, yi, mid);
        }
#pragma unroll
        for (int c = 0; c < CH; ++c)
          acc[c] = __fmaf_rn(wx, mid_operand<MODE, false>(mid[c]), acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) res[c][p] = MODE == INT8 ? __fmul_rn(acc[c], R127) : acc[c];
  }
}

// The same sums from the stage, without branches: a tap outside the region
// or its bounds is read at a harmless offset and its sum left unchanged by a
// select, so a warp never diverges. The footprint covers every valid tap
// (see footprint), so no tap is checked against it.
template <int MODE, bool RESIZE>
__device__ __forceinline__ void sample_staged(const Args& a, const Slot& sl, const Footprint& fp,
                                              const unsigned char* stage, int i, int j0, int jb,
                                              float (&res)[CH][4]) {
  const float fi = (float)i;
  const int col0 = sl.x0 * CH - fp.gstart;  // stage byte of region column 0, less 3 x
  const float hi_x = (float)(sl.reg_w + 1), hi_y = (float)(sl.reg_h + 1);
  float wr[2] = {0.f, 0.f};
  int rr[2] = {0, 0};
  bool vr[2] = {false, false};
  double m01i = 0.0, aai = 0.0;
  if (RESIZE) {  // one row position for the whole row: always inside the frame
    const float Y = resize_pos(i, a.ratio_y, a.H);
    int yi;
    const float yf = floor_small(Y, yi);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      vr[u] = (unsigned)(yi + u) < (unsigned)sl.reg_h;
      wr[u] = tap_weight<MODE>(Y, __fadd_rn(yf, (float)u));
      rr[u] = vr[u] ? (yi + u - fp.ylo) * fp.pitch : 0;
    }
  } else {
    m01i = (double)__fmul_rn(sl.m01, fi);        // the float32 product m01 * i
    aai = __dmul_rn((double)sl.aa, (double)fi);  // exact
  }
  const double jd0 = (double)j0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float xs =
        RESIZE ? resize_pos(j0 + p, a.ratio_x, a.W)
               : __fadd_rn(__double2float_rn(__dadd_rn(
                               __dmul_rn((double)sl.m00, __dadd_rn(jd0, (double)p)), m01i)),
                           sl.m02);
    const bool vx = j0 + p <= jb && xs >= a.lo && xs <= a.hi_w;
    int xi;
    const float xf = floor_small(fminf(fmaxf(xs, -2.0f), hi_x), xi);
    float acc[CH] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int x = xi + t;
      const float xt = __fadd_rn(xf, (float)t);
      const bool vt = vx && (unsigned)x < (unsigned)sl.reg_w;
      const float wx = tap_weight<MODE>(xs, xt);
      const int col = vt ? col0 + x * CH : 0;
      float w[2];
      int row[2];
      bool v[2];
      if (RESIZE) {
#pragma unroll
        for (int u = 0; u < 2; ++u) w[u] = wr[u], row[u] = rr[u], v[u] = vt && vr[u];
      } else {
        const float Y =
            __fadd_rn(__double2float_rn(__dadd_rn(aai, (double)__fmul_rn(sl.bb, xt))), sl.cc);
        const bool vy = vt && Y >= a.lo && Y <= a.hi_h;
        int yi;
        const float yf = floor_small(fminf(fmaxf(Y, -2.0f), hi_y), yi);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          v[u] = vy && (unsigned)(yi + u) < (unsigned)sl.reg_h;
          w[u] = tap_weight<MODE>(Y, __fadd_rn(yf, (float)u));
          row[u] = v[u] ? (yi + u - fp.ylo) * fp.pitch : 0;
        }
      }
      float mid[CH] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float px[CH];
        stage_pixel(stage, row[u] + col, px);
#pragma unroll
        for (int c = 0; c < CH; ++c) mid[c] = v[u] ? __fmaf_rn(w[u], px[c], mid[c]) : mid[c];
      }
#pragma unroll
      for (int c = 0; c < CH; ++c)
        acc[c] = vt ? __fmaf_rn(wx, mid_operand<MODE, true>(mid[c]), acc[c]) : acc[c];
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) res[c][p] = MODE == INT8 ? __fmul_rn(acc[c], R127) : acc[c];
  }
}

// One tile of slot s: every thread its four pixels of one row, all channels,
// normalised and written with one 16-byte store per channel plane.
template <bool U8, int MODE, bool RESIZE>
__device__ __forceinline__ void sample_tile(const Args& a, const Tiling& tl, const Slot& sl,
                                            const Footprint& fp_sm, const unsigned char* stage,
                                            const Rect& rc, int s) {
  const int i = rc.ia + threadIdx.x / tl.groups;
  const int j0 = rc.ja + 4 * (threadIdx.x % tl.groups);
  const int jb = rc.jb;
  if (i > rc.ib || j0 > jb) return;  // a thread of a partial tile
  float res[CH][4];
  if (U8 && fp_sm.use)
    sample_staged<MODE, RESIZE>(a, sl, fp_sm, stage, i, j0, jb, res);
  else
    sample_global<U8, MODE, RESIZE>(a, sl, i, j0, jb, res);
  if (a.normalize) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        res[c][p] =
            __fmul_rn(__fsub_rn(__fmul_rn(res[c][p], a.norm_mul), a.norm_sub), a.norm_scale);
  }
  const size_t plane = (size_t)a.out_h * a.out_w;
  const size_t at = (size_t)s * CH * plane + (size_t)i * a.out_w + j0;
  if (a.out_dtype == OUT_F32) {
    float* o = static_cast<float*>(a.out) + at;
    if (tl.vec) {
#pragma unroll
      for (int c = 0; c < CH; ++c)
        *reinterpret_cast<float4*>(o + c * plane) = make_float4(res[c][0], res[c][1], res[c][2], res[c][3]);
    } else {
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (j0 + p <= jb) o[c * plane + p] = res[c][p];
    }
    return;
  }
  // 16-bit output: each value rounded once, to nearest even.
  unsigned short h[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int p = 0; p < 4; ++p)
      h[c][p] = a.out_dtype == OUT_BF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(res[c][p]))
                                        : __half_as_ushort(__float2half_rn(res[c][p]));
  unsigned short* o = static_cast<unsigned short*>(a.out) + at;
  if (tl.vec) {  // at is a multiple of 4 elements: 8-byte aligned
#pragma unroll
    for (int c = 0; c < CH; ++c)
      *reinterpret_cast<uint2*>(o + c * plane) =
          make_uint2(h[c][0] | ((unsigned)h[c][1] << 16), h[c][2] | ((unsigned)h[c][3] << 16));
  } else {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (j0 + p <= jb) o[c * plane + p] = h[c][p];
  }
}

// grid (slots, groups of tl.per_block consecutive tiles of a slot's output);
// block tl.groups * tl.tile_h threads. Thread 0 computes the slot's
// parameters once, then the block runs its tiles as a two-stage pipeline:
// the footprint of tile k + 1 is copied into one stage buffer while tile k
// is sampled from the other.
template <bool U8, int MODE, bool RESIZE>
__global__ void __launch_bounds__(MAX_THREADS) warp_sample(const Args a, const Tiling tl) {
  __shared__ __align__(16) unsigned char stage[2][STAGE_BYTES + STAGE_PAD];
  __shared__ Slot slot_sm;
  __shared__ Footprint fp_sm[3];  // tile k's in fp_sm[k % 3]: thread 0 runs ahead by one
  const int s = blockIdx.x;
  const int q0 = blockIdx.y * tl.per_block;
  const int n = min(tl.per_block, tl.tiles - q0);
  if (threadIdx.x == 0) {
    Slot sl;
    block_slot<RESIZE>(a, s, sl);
    slot_sm = sl;
    const Rect rc = tile_rect(a, tl, q0);
    footprint<RESIZE>(a, tl, sl, rc.ia, rc.ib, rc.ja, rc.jb, fp_sm[0]);
  }
  __syncthreads();
  const Slot sl = slot_sm;
  if (U8) stage_tile(a, sl, fp_sm[0], stage[0]);
  for (int k = 0; k < n; ++k) {
    if (threadIdx.x == 0 && k + 1 < n) {
      const Rect rc = tile_rect(a, tl, q0 + k + 1);
      footprint<RESIZE>(a, tl, sl, rc.ia, rc.ib, rc.ja, rc.jb, fp_sm[(k + 1) % 3]);
    }
    __syncthreads();  // fp_sm[k + 1] is written; stage[(k + 1) & 1] is free
    if (U8) {
      if (k + 1 < n) {
        stage_tile(a, sl, fp_sm[(k + 1) % 3], stage[(k + 1) & 1]);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
    }
    __syncthreads();  // tile k's footprint is in stage[k & 1]
    sample_tile<U8, MODE, RESIZE>(a, tl, sl, fp_sm[k % 3], stage[k & 1],
                                  tile_rect(a, tl, q0 + k), s);
  }
}

template <bool U8, int MODE, bool RESIZE>
void launch(const Args& a, const Tiling& tl, int tiles, cudaStream_t st) {
  const dim3 grid(a.slots, tiles);
  warp_sample<U8, MODE, RESIZE><<<grid, tl.groups * tl.tile_h, 0, st>>>(a, tl);
}

}  // namespace

extern "C" {

// See Args. Slot s writes out[s] (3, out_h, out_w) in out_dtype: resized from
// frame s (landmarks and matrices null), warped from frame s by its forward
// map matrices[s], or warped from frame s / per_frame by the map its
// landmarks give, from the whole frame or (window > 0) from its window^2
// crop, zero outside it; `fast` F32, BF16 or INT8 (INT8 not with the
// resize). Returns 0, a CUDA error code, or -1 for arguments it cannot run.
int warp_sample_launch(const WarpArgs* args, int device, void* stream) {
  if (args == nullptr) return -1;
  const Args& a = *args;
  const bool resize = a.landmarks == nullptr && a.matrices == nullptr;
  if ((a.landmarks != nullptr && a.matrices != nullptr) ||
      (a.matrices != nullptr && (a.per_frame != 1 || a.window != 0)))
    return -1;
  if (a.frames == nullptr || a.out == nullptr || a.slots < 1 || a.n_frames < 1 || a.H < 1 ||
      a.W < 1 || a.out_h < 1 || a.out_w < 1 || a.per_frame < 1 ||
      (long long)a.n_frames * a.per_frame != a.slots || a.window < 0 || a.window > a.H ||
      a.window > a.W || (resize && (a.per_frame != 1 || a.window != 0)) ||
      (!resize && a.window > 0 && a.out_h != a.out_w) || a.fast < F32 || a.fast > INT8 ||
      (resize && a.fast == INT8) || a.out_dtype < OUT_F32 || a.out_dtype > OUT_F16)
    return -1;
  Tiling tl;
  const int groups = (a.out_w + 3) / 4;
  tl.tiles_x = (groups + MAX_GROUPS - 1) / MAX_GROUPS;
  tl.groups = (groups + tl.tiles_x - 1) / tl.tiles_x;
  tl.tile_w = 4 * tl.groups;
  const int max_h = MAX_THREADS / tl.groups;
  const int tiles_y = (a.out_h + max_h - 1) / max_h;
  tl.tile_h = (a.out_h + tiles_y - 1) / tiles_y;
  tl.tiles = tl.tiles_x * tiles_y;
  tl.vec = a.out_w % 4 == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  tl.stage_ok = a.frames_u8 && (a.W * CH) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(a.frames) % 16 == 0;
  int caller_device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // Enough consecutive tiles per block that the grid fits one wave (about
  // six blocks an SM): the slot's solve is paid once per block and the
  // pipeline has tiles to overlap.
  const long long total = (long long)a.slots * tl.tiles;
  const long long wave = 6LL * sms;
  tl.per_block = (int)std::min<long long>(8, std::max<long long>(1, (total + wave - 1) / wave));
  const int tiles = (tl.tiles + tl.per_block - 1) / tl.per_block;
  if (tiles > 65535) {
    cudaSetDevice(caller_device);
    return -1;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int mode = (a.frames_u8 ? 6 : 0) + 2 * a.fast + (resize ? 1 : 0);
  switch (mode) {
    case 0: launch<false, F32, false>(a, tl, (int)tiles, st); break;
    case 1: launch<false, F32, true>(a, tl, (int)tiles, st); break;
    case 2: launch<false, BF16, false>(a, tl, (int)tiles, st); break;
    case 3: launch<false, BF16, true>(a, tl, (int)tiles, st); break;
    case 4: launch<false, INT8, false>(a, tl, (int)tiles, st); break;
    case 6: launch<true, F32, false>(a, tl, (int)tiles, st); break;
    case 7: launch<true, F32, true>(a, tl, (int)tiles, st); break;
    case 8: launch<true, BF16, false>(a, tl, (int)tiles, st); break;
    case 9: launch<true, BF16, true>(a, tl, (int)tiles, st); break;
    default: launch<true, INT8, false>(a, tl, (int)tiles, st); break;
  }
  err = cudaGetLastError();
  const cudaError_t restored = cudaSetDevice(caller_device);
  if (err != cudaSuccess) return (int)err;
  return (int)restored;
}

}  // extern "C"
