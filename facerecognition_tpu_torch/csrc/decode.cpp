// Host image decoding for facerecognition_tpu_torch: JPEG and PNG bytes to
// RGB8, one image or a batch of files in parallel with a bilinear resize.
//
// The port's copy of native/decode.cpp (libjpeg + libpng, a pthread batch
// API, the half-pixel bilinear resize), rebuilt for machines that lack
// libjpeg and libpng:
//
// - PNG is read here on zlib: every colour type and bit depth, Adam7
//   interlacing, chunk CRCs checked. Conversions to RGB8 are libpng's with
//   native/decode.cpp's transforms: 16-bit samples keep their high byte
//   (png_set_strip_16), 1/2/4-bit gray is scaled to 0..255
//   (png_set_expand_gray_1_2_4_to_8), palettes are looked up, alpha and
//   tRNS are dropped.
// - JPEG is entropy-decoded and inverse-transformed by libjpeg when
//   FRT_JPEG_LIBJPEG is defined, by the CUDA toolkit's nvJPEG when
//   FRT_JPEG_NVJPEG is (on the current CUDA device, copied back), and is
//   refused otherwise. Both leave the components planar at their own
//   sampling; the upsampling and the YCbCr -> RGB conversion are libjpeg's
//   defaults rebuilt here (planes_to_rgb), so only nvJPEG's IDCT differs
//   from libjpeg's pixels. The build (_build.build_host) defines one of the
//   two from what the machine has, and frt_jpeg_backend() names it.
//   CMYK/YCCK JPEGs are refused by name.
//
// C interface, loaded with ctypes (data/native_decode.py). Build:
//   g++ -O3 -std=c++17 -shared -fPIC decode.cpp -lz -lpthread
//       [-DFRT_JPEG_LIBJPEG -ljpeg | -DFRT_JPEG_NVJPEG <cuda> -lnvjpeg -lcudart_static]

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <pthread.h>
#include <string>
#include <vector>

#include <zlib.h>

#if defined(FRT_JPEG_LIBJPEG)
#include <csetjmp>
#include <jpeglib.h>
#elif defined(FRT_JPEG_NVJPEG)
#include <cuda_runtime.h>
#include <nvjpeg.h>
#endif

namespace {

using Bytes = std::vector<uint8_t>;

// -- JPEG --------------------------------------------------------------------
//
// Both backends leave the components planar at their own sampling (the
// IDCT's output); planes_to_rgb then upsamples and converts them as
// libjpeg(-turbo) does by default, so the libjpeg backend gives libjpeg's
// RGB bits and the nvJPEG backend differs from them only by its IDCT.

// What the markers before the first SOF say.
struct JpegLayout {
  int components = 0;
  int h[4] = {0}, v[4] = {0}, ids[4] = {0};
  bool jfif = false;
  int adobe_transform = -1;  // -1: no Adobe APP14 marker
};

bool parse_jpeg(const uint8_t *d, size_t n, JpegLayout *L) {
  size_t p = 2;
  while (p + 4 <= n) {
    if (d[p] != 0xFF) return false;
    const uint8_t m = d[p + 1];
    if (m == 0xFF) { ++p; continue; }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) { p += 2; continue; }
    const size_t len = (static_cast<size_t>(d[p + 2]) << 8) | d[p + 3];
    const uint8_t *body = d + p + 4;
    if (p + 2 + len > n || len < 2) return false;
    if (m == 0xE0 && len >= 7 && memcmp(body, "JFIF", 5) == 0) L->jfif = true;
    if (m == 0xEE && len >= 14 && memcmp(body, "Adobe", 5) == 0) L->adobe_transform = body[11];
    const bool sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
    if (sof) {
      if (len < 8) return false;
      L->components = body[5];
      if (L->components > 4 || len < 8 + 3 * static_cast<size_t>(L->components)) return false;
      for (int c = 0; c < L->components; ++c) {
        L->ids[c] = body[6 + 3 * c];
        L->h[c] = body[7 + 3 * c] >> 4;
        L->v[c] = body[7 + 3 * c] & 15;
      }
      return true;
    }
    if (m == 0xDA || m == 0xD9) return false;
    p += 2 + len;
  }
  return false;
}

// libjpeg's guess of a 3-component file's colour space (jdapimin.c):
// RGB under an Adobe marker with transform 0 or with component ids R, G, B.
bool components_are_rgb(const JpegLayout &L) {
  if (L.jfif) return false;
  if (L.adobe_transform >= 0) return L.adobe_transform == 0;
  return L.ids[0] == 'R' && L.ids[1] == 'G' && L.ids[2] == 'B';
}

struct Planes {
  int width = 0, height = 0, n = 0;
  bool rgb = false;  // three components that need no colour conversion
  int h[3] = {1, 1, 1}, v[3] = {1, 1, 1};
  int dw[3] = {0}, dh[3] = {0}, stride[3] = {0};  // each plane's own size
  Bytes data[3];
};

// One plane brought to full size (width x height): libjpeg-turbo's
// upsamplers with do_fancy_upsampling (jdsample.c): the triangle filters
// for 2x1, 1x2 and 2x2 (context rows at the edges replicate the first and
// last rows), plain replication for other integral ratios and for planes
// at most 2 samples wide at 2x1/2x2.
bool upsample(const Planes &P, int c, int max_h, int max_v, Bytes *full, std::string *error) {
  const int W = P.width, H = P.height;
  const int hx = max_h / P.h[c], vy = max_v / P.v[c];
  if (hx * P.h[c] != max_h || vy * P.v[c] != max_v) {
    *error = "JPEG: unsupported sampling factors";
    return false;
  }
  const int dw = P.dw[c], dh = P.dh[c];
  if (dw * hx < W || dh * vy < H) {
    *error = "JPEG: component plane smaller than the image";
    return false;
  }
  const uint8_t *src = P.data[c].data();
  const int stride = P.stride[c];
  auto row = [&](int r) { return src + static_cast<size_t>(r < 0 ? 0 : (r >= dh ? dh - 1 : r)) * stride; };
  full->resize(static_cast<size_t>(W) * H);
  std::vector<int> line(static_cast<size_t>(dw) * hx + 2);
  for (int y = 0; y < H; ++y) {
    uint8_t *out = full->data() + static_cast<size_t>(y) * W;
    const int r = y / vy;
    if (hx == 2 && vy == 2 && dw > 2) {
      const uint8_t *in0 = row(r), *in1 = row(y % 2 == 0 ? r - 1 : r + 1);
      int *o = line.data();
      int this_sum = in0[0] * 3 + in1[0], next_sum = in0[1] * 3 + in1[1], last_sum;
      *o++ = (this_sum * 4 + 8) >> 4;
      *o++ = (this_sum * 3 + next_sum + 7) >> 4;
      last_sum = this_sum, this_sum = next_sum;
      for (int x = 2; x < dw; ++x) {
        next_sum = in0[x] * 3 + in1[x];
        *o++ = (this_sum * 3 + last_sum + 8) >> 4;
        *o++ = (this_sum * 3 + next_sum + 7) >> 4;
        last_sum = this_sum, this_sum = next_sum;
      }
      *o++ = (this_sum * 3 + last_sum + 8) >> 4;
      *o++ = (this_sum * 4 + 7) >> 4;
      for (int x = 0; x < W; ++x) out[x] = static_cast<uint8_t>(line[x]);
    } else if (hx == 2 && vy == 1 && dw > 2) {
      const uint8_t *in = row(r);
      int *o = line.data();
      *o++ = in[0];
      *o++ = (in[0] * 3 + in[1] + 2) >> 2;
      for (int x = 1; x < dw - 1; ++x) {
        const int v3 = in[x] * 3;
        *o++ = (v3 + in[x - 1] + 1) >> 2;
        *o++ = (v3 + in[x + 1] + 2) >> 2;
      }
      *o++ = (in[dw - 1] * 3 + in[dw - 2] + 1) >> 2;
      *o++ = in[dw - 1];
      for (int x = 0; x < W; ++x) out[x] = static_cast<uint8_t>(line[x]);
    } else if (hx == 1 && vy == 2) {
      const uint8_t *in0 = row(r);
      const bool up = y % 2 == 0;
      const uint8_t *in1 = row(up ? r - 1 : r + 1);
      const int bias = up ? 1 : 2;
      for (int x = 0; x < W; ++x) out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    } else {
      const uint8_t *in = row(r);
      for (int x = 0; x < W; ++x) out[x] = in[x / hx];
    }
  }
  return true;
}

// YCbCr -> RGB with libjpeg's tables (jdcolor.c, 16 fractional bits).
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = 1 << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

bool planes_to_rgb(const Planes &P, Bytes *out, std::string *error) {
  static const YccTables T;
  const size_t npx = static_cast<size_t>(P.width) * P.height;
  out->resize(npx * 3);
  int max_h = 1, max_v = 1;
  for (int c = 0; c < P.n; ++c) {
    max_h = P.h[c] > max_h ? P.h[c] : max_h;
    max_v = P.v[c] > max_v ? P.v[c] : max_v;
  }
  Bytes full[3];
  for (int c = 0; c < P.n; ++c)
    if (!upsample(P, c, max_h, max_v, &full[c], error)) return false;
  uint8_t *o = out->data();
  if (P.n == 1) {
    for (size_t i = 0; i < npx; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = full[0][i];
  } else if (P.rgb) {
    for (size_t i = 0; i < npx; ++i)
      o[3 * i] = full[0][i], o[3 * i + 1] = full[1][i], o[3 * i + 2] = full[2][i];
  } else {
    for (size_t i = 0; i < npx; ++i) {
      const int y = full[0][i], cb = full[1][i], cr = full[2][i];
      o[3 * i] = clamp255(y + T.cr_r[cr]);
      o[3 * i + 1] = clamp255(y + static_cast<int>((T.cb_g[cb] + T.cr_g[cr]) >> 16));
      o[3 * i + 2] = clamp255(y + T.cb_b[cb]);
    }
  }
  return true;
}

#if defined(FRT_JPEG_LIBJPEG)

const char *kJpegBackend = "libjpeg";

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
  char message[JMSG_LENGTH_MAX];
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto *err = reinterpret_cast<JpegErrorMgr *>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  longjmp(err->setjmp_buffer, 1);
}

void jpeg_silent(j_common_ptr) {}

// libjpeg's raw (planar, not upsampled) output: its IDCT, our planes_to_rgb.
bool decode_jpeg_planes(const uint8_t *data, size_t size, const JpegLayout &, Planes *P,
                        std::string *error) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  jerr.message[0] = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  jerr.pub.output_message = jpeg_silent;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    *error = std::string("JPEG: ") + jerr.message;
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t *>(data), static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  const J_COLOR_SPACE space = cinfo.jpeg_color_space;
  if (!(space == JCS_GRAYSCALE && cinfo.num_components == 1) &&
      !((space == JCS_YCbCr || space == JCS_RGB) && cinfo.num_components == 3)) {
    jpeg_destroy_decompress(&cinfo);
    *error = "JPEG: unsupported colour space (" + std::to_string(cinfo.num_components) +
             " components)";
    return false;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  P->width = cinfo.output_width;
  P->height = cinfo.output_height;
  P->n = cinfo.num_components;
  P->rgb = space == JCS_RGB;
  const int imcu_rows = cinfo.max_v_samp_factor * DCTSIZE;
  std::vector<JSAMPROW> rows[3];
  for (int c = 0; c < P->n; ++c) {
    const jpeg_component_info &comp = cinfo.comp_info[c];
    P->h[c] = comp.h_samp_factor;
    P->v[c] = comp.v_samp_factor;
    P->dw[c] = comp.downsampled_width;
    P->dh[c] = comp.downsampled_height;
    P->stride[c] = comp.width_in_blocks * DCTSIZE;
    const size_t total_rows = static_cast<size_t>(cinfo.total_iMCU_rows) * comp.v_samp_factor * DCTSIZE;
    P->data[c].assign(total_rows * P->stride[c], 0);
    rows[c].resize(static_cast<size_t>(comp.v_samp_factor) * DCTSIZE);
  }
  for (JDIMENSION k = 0; cinfo.output_scanline < cinfo.output_height; ++k) {
    JSAMPARRAY planes[3];
    for (int c = 0; c < P->n; ++c) {
      const size_t n_rows = rows[c].size();
      for (size_t r = 0; r < n_rows; ++r)
        rows[c][r] = P->data[c].data() + (k * n_rows + r) * P->stride[c];
      planes[c] = rows[c].data();
    }
    jpeg_read_raw_data(&cinfo, planes, imcu_rows);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

#elif defined(FRT_JPEG_NVJPEG)

const char *kJpegBackend = "nvjpeg";

// One handle, state, stream and device buffer, behind a lock: the batch
// API's threads take turns on the card.
struct NvJpeg {
  std::mutex mutex;
  bool ready = false;
  std::string init_error;
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t *buffer = nullptr;
  size_t capacity = 0;
};

NvJpeg &nv() {
  static NvJpeg instance;
  return instance;
}

std::string nv_status(const char *what, int status) {
  return std::string("JPEG: nvJPEG ") + what + " failed (status " +
         std::to_string(status) + ")";
}

// nvJPEG's planar output (NVJPEG_OUTPUT_YUV: each component at its own
// sampling), copied back to the host.
bool decode_jpeg_planes(const uint8_t *data, size_t size, const JpegLayout &L, Planes *P,
                        std::string *error) {
  NvJpeg &s = nv();
  std::lock_guard<std::mutex> lock(s.mutex);
  if (!s.ready) {
    if (!s.init_error.empty()) {
      *error = s.init_error;
      return false;
    }
    int st = nvjpegCreateSimple(&s.handle);
    if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegJpegStateCreate(s.handle, &s.state);
    if (st != NVJPEG_STATUS_SUCCESS) {
      s.init_error = nv_status("initialisation", st);
      *error = s.init_error;
      return false;
    }
    cudaError_t ce = cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking);
    if (ce != cudaSuccess) {
      s.init_error = std::string("JPEG: nvJPEG needs a CUDA device: ") + cudaGetErrorString(ce);
      *error = s.init_error;
      return false;
    }
    s.ready = true;
  }
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  int st = nvjpegGetImageInfo(s.handle, data, size, &components, &subsampling, widths, heights);
  if (st != NVJPEG_STATUS_SUCCESS) {
    *error = nv_status("header", st);
    return false;
  }
  if (components != L.components || (components != 1 && components != 3)) {
    *error = "JPEG: unsupported component count " + std::to_string(components);
    return false;
  }
  P->width = widths[0];
  P->height = heights[0];
  P->n = components;
  P->rgb = components == 3 && components_are_rgb(L);
  int max_h = 1, max_v = 1;
  for (int c = 0; c < components; ++c) {
    max_h = L.h[c] > max_h ? L.h[c] : max_h;
    max_v = L.v[c] > max_v ? L.v[c] : max_v;
  }
  size_t offsets[3] = {0, 0, 0}, total = 0;
  for (int c = 0; c < components; ++c) {
    P->h[c] = L.h[c];
    P->v[c] = L.v[c];
    // libjpeg's downsampled size: ceil(image size * factor / max factor)
    const int dw = (P->width * L.h[c] + max_h - 1) / max_h;
    const int dh = (P->height * L.v[c] + max_v - 1) / max_v;
    if (widths[c] != dw || heights[c] != dh) {
      *error = "JPEG: nvJPEG component " + std::to_string(c) + " is " + std::to_string(widths[c]) +
               "x" + std::to_string(heights[c]) + ", expected " + std::to_string(dw) + "x" +
               std::to_string(dh);
      return false;
    }
    P->dw[c] = P->stride[c] = dw;
    P->dh[c] = dh;
    offsets[c] = total;
    total += static_cast<size_t>(dw) * dh;
  }
  if (P->width <= 0 || P->height <= 0) {
    *error = "JPEG: empty image";
    return false;
  }
  if (total > s.capacity) {
    if (s.buffer) cudaFree(s.buffer);
    s.buffer = nullptr;
    s.capacity = 0;
    if (cudaMalloc(&s.buffer, total) != cudaSuccess) {
      *error = "JPEG: nvJPEG output buffer: cudaMalloc failed";
      return false;
    }
    s.capacity = total;
  }
  nvjpegImage_t image;
  memset(&image, 0, sizeof(image));
  for (int c = 0; c < components; ++c) {
    image.channel[c] = s.buffer + offsets[c];
    image.pitch[c] = static_cast<unsigned int>(P->stride[c]);
  }
  st = nvjpegDecode(s.handle, s.state, data, size,
                    components == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &image, s.stream);
  if (st != NVJPEG_STATUS_SUCCESS) {
    *error = nv_status("decode", st);
    return false;
  }
  Bytes host(total);
  cudaError_t ce = cudaMemcpyAsync(host.data(), s.buffer, total, cudaMemcpyDeviceToHost, s.stream);
  if (ce == cudaSuccess) ce = cudaStreamSynchronize(s.stream);
  if (ce != cudaSuccess) {
    *error = std::string("JPEG: nvJPEG copy: ") + cudaGetErrorString(ce);
    return false;
  }
  for (int c = 0; c < components; ++c)
    P->data[c].assign(host.begin() + offsets[c],
                      host.begin() + offsets[c] + static_cast<size_t>(P->dw[c]) * P->dh[c]);
  return true;
}

#else

const char *kJpegBackend = "none";

bool decode_jpeg_planes(const uint8_t *, size_t, const JpegLayout &, Planes *, std::string *error) {
  *error =
      "JPEG: no JPEG decoder was built (neither libjpeg nor the CUDA "
      "toolkit's nvJPEG was found)";
  return false;
}

#endif

bool decode_jpeg(const uint8_t *data, size_t size, Bytes *out, int *width, int *height,
                 std::string *error) {
  JpegLayout layout;
  if (!parse_jpeg(data, size, &layout)) {
    *error = "JPEG: no frame header (corrupt or truncated file)";
    return false;
  }
  if (layout.components == 4) {
    *error = "JPEG: CMYK/YCCK JPEG is not supported";
    return false;
  }
  Planes planes;
  if (!decode_jpeg_planes(data, size, layout, &planes, error)) return false;
  if (!planes_to_rgb(planes, out, error)) return false;
  *width = planes.width;
  *height = planes.height;
  return true;
}

// -- PNG ---------------------------------------------------------------------

const uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

uint32_t be32(const uint8_t *p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

struct Pass {
  int x0, y0, dx, dy;
};
const Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                        {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
const Pass kWhole = {0, 0, 1, 1};

bool valid_depth(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Undo the filter of one row in place; prev is the previous unfiltered row
// of the pass (nullptr for the first).
bool unfilter(uint8_t type, uint8_t *row, const uint8_t *prev, size_t n, size_t bpp) {
  switch (type) {
    case 0: return true;
    case 1:
      for (size_t i = bpp; i < n; ++i) row[i] += row[i - bpp];
      return true;
    case 2:
      if (prev) for (size_t i = 0; i < n; ++i) row[i] += prev[i];
      return true;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        int a = i >= bpp ? row[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        row[i] += static_cast<uint8_t>((a + b) >> 1);
      }
      return true;
    case 4:
      for (size_t i = 0; i < n; ++i) {
        int a = i >= bpp ? row[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        int c = prev && i >= bpp ? prev[i - bpp] : 0;
        row[i] += paeth(a, b, c);
      }
      return true;
    default:
      return false;
  }
}

bool inflate_all(const Bytes &in, Bytes *out, std::string *error) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) {
    *error = "PNG: zlib inflateInit failed";
    return false;
  }
  zs.next_in = const_cast<Bytes::value_type *>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(out->size());
  int rc = Z_OK;
  while (zs.avail_out > 0 && rc == Z_OK) rc = inflate(&zs, Z_NO_FLUSH);
  const size_t produced = out->size() - zs.avail_out;
  inflateEnd(&zs);
  if (rc != Z_OK && rc != Z_STREAM_END && rc != Z_BUF_ERROR) {
    *error = std::string("PNG: corrupt image data (zlib: ") +
             (zs.msg ? zs.msg : "error") + ")";
    return false;
  }
  if (produced != out->size()) {
    *error = "PNG: image data is truncated";
    return false;
  }
  return true;
}

bool decode_png(const uint8_t *d, size_t n, Bytes *out, int *width, int *height,
                std::string *error) {
  if (n < 8 || memcmp(d, kPngSignature, 8) != 0) {
    *error = "PNG: bad signature";
    return false;
  }
  uint32_t w = 0, h = 0;
  int depth = 0, color = -1, interlace = 0;
  bool have_header = false;
  std::vector<uint8_t> palette;  // RGB triples
  Bytes idat;
  size_t p = 8;
  while (p + 12 <= n) {
    const uint32_t len = be32(d + p);
    if (len > n - p - 12) {
      *error = "PNG: truncated chunk";
      return false;
    }
    const uint8_t *type = d + p + 4;
    const uint8_t *body = d + p + 8;
    const uint32_t crc = be32(body + len);
    if (static_cast<uint32_t>(crc32(crc32(0L, Z_NULL, 0), type, len + 4)) != crc) {
      *error = std::string("PNG: CRC mismatch in chunk ") +
               std::string(reinterpret_cast<const char *>(type), 4);
      return false;
    }
    if (!have_header && memcmp(type, "IHDR", 4) != 0) {
      *error = "PNG: IHDR is not the first chunk";
      return false;
    }
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len != 13 || have_header) {
        *error = "PNG: bad IHDR";
        return false;
      }
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      color = body[9];
      interlace = body[12];
      if (body[10] != 0 || body[11] != 0 || interlace > 1) {
        *error = "PNG: unknown compression, filter or interlace method";
        return false;
      }
      if (!valid_depth(color, depth)) {
        *error = "PNG: invalid colour type " + std::to_string(color) +
                 " at bit depth " + std::to_string(depth);
        return false;
      }
      if (w == 0 || h == 0 || static_cast<uint64_t>(w) * h > (1ull << 28)) {
        *error = "PNG: unsupported size " + std::to_string(w) + "x" + std::to_string(h);
        return false;
      }
      have_header = true;
    } else if (memcmp(type, "PLTE", 4) == 0) {
      palette.assign(body, body + (len / 3) * 3);
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;  // a missing IEND is tolerated, as by libpng's reader
    }
    p += 12 + len;
  }
  if (!have_header || idat.empty()) {
    *error = "PNG: no image data";
    return false;
  }
  if (color == 3 && palette.empty()) {
    *error = "PNG: palette image without PLTE";
    return false;
  }
  const int channels = color == 0 || color == 3 ? 1 : color == 2 ? 3 : color == 4 ? 2 : 4;
  const size_t bits = static_cast<size_t>(channels) * depth;
  const size_t bpp = bits >= 8 ? bits / 8 : 1;  // filter unit in bytes
  const int n_passes = interlace ? 7 : 1;
  const Pass *passes = interlace ? kAdam7 : &kWhole;
  size_t raw_size = 0;
  for (int i = 0; i < n_passes; ++i) {
    const Pass &ps = passes[i];
    const size_t pw = w > static_cast<uint32_t>(ps.x0) ? (w - ps.x0 + ps.dx - 1) / ps.dx : 0;
    const size_t ph = h > static_cast<uint32_t>(ps.y0) ? (h - ps.y0 + ps.dy - 1) / ps.dy : 0;
    if (pw && ph) raw_size += ph * (1 + (pw * bits + 7) / 8);
  }
  Bytes raw(raw_size);
  if (!inflate_all(idat, &raw, error)) return false;

  out->assign(static_cast<size_t>(w) * h * 3, 0);
  const int max_gray = (1 << (depth < 8 ? depth : 8)) - 1;
  const size_t n_palette = palette.size() / 3;
  uint8_t *rgb = out->data();
  size_t offset = 0;
  for (int i = 0; i < n_passes; ++i) {
    const Pass &ps = passes[i];
    const size_t pw = w > static_cast<uint32_t>(ps.x0) ? (w - ps.x0 + ps.dx - 1) / ps.dx : 0;
    const size_t ph = h > static_cast<uint32_t>(ps.y0) ? (h - ps.y0 + ps.dy - 1) / ps.dy : 0;
    if (!pw || !ph) continue;
    const size_t rowbytes = (pw * bits + 7) / 8;
    const uint8_t *prev = nullptr;
    for (size_t y = 0; y < ph; ++y) {
      uint8_t *row = raw.data() + offset + 1;
      if (!unfilter(row[-1], row, prev, rowbytes, bpp)) {
        *error = "PNG: unknown filter type " + std::to_string(row[-1]);
        return false;
      }
      prev = row;
      offset += 1 + rowbytes;
      const size_t oy = ps.y0 + y * ps.dy;
      for (size_t x = 0; x < pw; ++x) {
        uint8_t *px = rgb + (oy * w + ps.x0 + x * ps.dx) * 3;
        // sample k of pixel x: high byte at 16 bits, unpacked below 8 bits
        auto sample = [&](int k) -> int {
          if (depth == 16) return row[(x * channels + k) * 2];
          if (depth == 8) return row[x * channels + k];
          const size_t bit = x * depth;
          return (row[bit / 8] >> (8 - depth - bit % 8)) & max_gray;
        };
        if (color == 3) {
          const int idx = sample(0);
          if (static_cast<size_t>(idx) < n_palette) memcpy(px, &palette[3 * idx], 3);
        } else if (color == 2 || color == 6) {
          px[0] = sample(0), px[1] = sample(1), px[2] = sample(2);
        } else {
          const int v = depth < 8 ? sample(0) * 255 / max_gray : sample(0);
          px[0] = px[1] = px[2] = static_cast<uint8_t>(v);
        }
      }
    }
  }
  *width = static_cast<int>(w);
  *height = static_cast<int>(h);
  return true;
}

// -- dispatch, files, resize, batch ------------------------------------------

bool decode_any(const uint8_t *data, size_t size, Bytes *rgb, int *w, int *h,
                std::string *error) {
  if (size >= 8 && memcmp(data, kPngSignature, 8) == 0)
    return decode_png(data, size, rgb, w, h, error);
  if (size >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF)
    return decode_jpeg(data, size, rgb, w, h, error);
  *error = "not a JPEG or PNG file";
  return false;
}

bool read_file(const char *path, Bytes *buf) {
  FILE *f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  const long n = ok ? ftell(f) : -1;
  ok = n > 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize(static_cast<size_t>(n));
    ok = fread(buf->data(), 1, buf->size(), f) == buf->size();
  }
  fclose(f);
  return ok;
}

// Bilinear resize of RGB8, half-pixel centres (native/decode.cpp's).
void resize_bilinear(const uint8_t *src, int sw, int sh, uint8_t *dst, int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 > sh - 1 ? sh - 1 : y0 + 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > sw - 1) x0 = sw - 1;
      int x1 = x0 + 1 > sw - 1 ? sw - 1 : x0 + 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(y0 * sw + x0) * 3 + c];
        float v01 = src[(y0 * sw + x1) * 3 + c];
        float v10 = src[(y1 * sw + x0) * 3 + c];
        float v11 = src[(y1 * sw + x1) * 3 + c];
        float top = v00 * (1 - wx) + v01 * wx;
        float bot = v10 * (1 - wx) + v11 * wx;
        float v = top * (1 - wy) + bot * wy;
        dst[(y * dw + x) * 3 + c] =
            static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f));
      }
    }
  }
}

bool decode_file_to(const char *path, uint8_t *dst, int size) {
  Bytes buf, rgb;
  int w = 0, h = 0;
  std::string error;
  if (!read_file(path, &buf) || !decode_any(buf.data(), buf.size(), &rgb, &w, &h, &error))
    return false;
  if (w == size && h == size)
    memcpy(dst, rgb.data(), static_cast<size_t>(size) * size * 3);
  else
    resize_bilinear(rgb.data(), w, h, dst, size, size);
  return true;
}

struct BatchTask {
  const char **paths;
  uint8_t *out;  // (n, size, size, 3)
  uint8_t *ok;   // (n,)
  int size;
  int n;
  int next;  // guarded by mutex
  pthread_mutex_t mutex;
};

void *batch_worker(void *arg) {
  auto *task = static_cast<BatchTask *>(arg);
  const size_t stride = static_cast<size_t>(task->size) * task->size * 3;
  for (;;) {
    pthread_mutex_lock(&task->mutex);
    const int i = task->next++;
    pthread_mutex_unlock(&task->mutex);
    if (i >= task->n) return nullptr;
    task->ok[i] = decode_file_to(task->paths[i], task->out + i * stride, task->size) ? 1 : 0;
  }
}

void set_error(const std::string &message, char *err, int err_cap) {
  if (err && err_cap > 0) {
    strncpy(err, message.c_str(), static_cast<size_t>(err_cap) - 1);
    err[err_cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

// "libjpeg", "nvjpeg" or "none": how this build decodes JPEG.
const char *frt_jpeg_backend() { return kJpegBackend; }

// Decode JPEG/PNG bytes at their own size. On success returns 1, sets *w,
// *h and *out to a malloc'd w*h*3 RGB8 buffer the caller releases with
// frt_free. On failure returns 0 and writes the reason into err.
int frt_decode_alloc(const uint8_t *data, long size, uint8_t **out, int *w, int *h,
                     char *err, int err_cap) {
  Bytes rgb;
  std::string error;
  *out = nullptr;
  *w = *h = 0;
  if (size <= 0 || !decode_any(data, static_cast<size_t>(size), &rgb, w, h, &error)) {
    set_error(error.empty() ? "empty file" : error, err, err_cap);
    return 0;
  }
  *out = static_cast<uint8_t *>(malloc(rgb.size()));
  if (!*out) {
    set_error("out of memory", err, err_cap);
    return 0;
  }
  memcpy(*out, rgb.data(), rgb.size());
  return 1;
}

void frt_free(uint8_t *ptr) { free(ptr); }

// Decode n files with n_threads workers: out (n, size, size, 3) RGB8, ok (n,)
// success flags. Returns the number decoded.
int frt_decode_batch(const char **paths, int n, uint8_t *out, uint8_t *ok, int size,
                     int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  BatchTask task{paths, out, ok, size, n, 0, PTHREAD_MUTEX_INITIALIZER};
  std::vector<pthread_t> threads(static_cast<size_t>(n_threads));
  for (auto &t : threads) pthread_create(&t, nullptr, batch_worker, &task);
  for (auto &t : threads) pthread_join(t, nullptr);
  int good = 0;
  for (int i = 0; i < n; ++i) good += ok[i];
  return good;
}

}  // extern "C"
