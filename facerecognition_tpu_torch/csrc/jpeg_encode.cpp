// Baseline JPEG encoding for facerecognition_tpu_torch: RGB8 to JFIF bytes,
// for the realtime app's MJPEG stream (utils/imageio.encode_jpeg).
//
// What libjpeg writes with its defaults (jpeg_set_defaults +
// jpeg_set_quality): 8-bit samples, YCbCr 4:2:0 (Y 2x2, Cb and Cr 1x1),
// the standard quantisation tables of the JPEG spec (K.1, K.2) scaled by
// quality as jpeg_quality_scaling does and clamped to 1..255, the standard
// Huffman tables (K.3, K.5), one interleaved sequential scan, a JFIF 1.01
// APP0. The colour conversion and the 2x2 chroma averaging are libjpeg's
// fixed-point arithmetic (jccolor.c rgb_ycc_convert, jcsample.c
// h2v2_downsample with its alternating bias), the picture is padded to whole
// MCUs by repeating its last column and row, as libjpeg's edge expansion
// does. The forward DCT is a separable float DCT-II with coefficients
// rounded to nearest at quantisation (libjpeg's default is its integer
// "islow" DCT, so coefficients may differ by one step now and then).
//
// C interface, loaded with ctypes (utils/imageio.py). Build:
//   g++ -O3 -std=c++17 -shared -fPIC jpeg_encode.cpp

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

using Bytes = std::vector<uint8_t>;

// Table K.1 and K.2, in natural (row-major) order.
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// zigzag position k -> natural index
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Table K.3 / K.4 (DC) and K.5 / K.6 (AC): code counts by length 1..16, values.
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// A Huffman table's code and length per symbol (jpeg_make_c_derived_tbl).
struct HuffCodes {
  uint16_t code[256] = {0};
  uint8_t size[256] = {0};
};

HuffCodes derive(const uint8_t bits[16], const uint8_t *vals) {
  HuffCodes t;
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      t.code[vals[k]] = static_cast<uint16_t>(code++);
      t.size[vals[k]] = static_cast<uint8_t>(len);
    }
    code <<= 1;
  }
  return t;
}

// jpeg_quality_scaling + jpeg_add_quant_table(force_baseline = TRUE).
void scaled_table(const int base[64], int quality, int out[64]) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long v = (base[i] * scale + 50L) / 100L;
    out[i] = static_cast<int>(v < 1 ? 1 : (v > 255 ? 255 : v));
  }
}

class BitWriter {
 public:
  explicit BitWriter(Bytes *out) : out_(out) {}
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    n_ += size;
    while (n_ >= 8) {
      const uint8_t byte = static_cast<uint8_t>(acc_ >> (n_ - 8));
      out_->push_back(byte);
      if (byte == 0xFF) out_->push_back(0);  // byte stuffing
      n_ -= 8;
    }
    acc_ &= (1u << n_) - 1;
  }
  void flush() {  // pad the last byte with 1 bits
    if (n_ > 0) put((1u << (8 - n_)) - 1, 8 - n_);
  }

 private:
  Bytes *out_;
  uint32_t acc_ = 0;
  int n_ = 0;
};

// The orthonormal DCT-II basis of 8 points: c[u][x].
struct Dct {
  float c[8][8];
  Dct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = static_cast<float>((u == 0 ? std::sqrt(0.125) : 0.5) *
                                     std::cos((2 * x + 1) * u * M_PI / 16.0));
  }
};

const Dct &dct() {
  static const Dct d;
  return d;
}

// Forward DCT of one 8x8 block of level-shifted samples, quantised by q
// (natural order) with rounding to nearest, ties away from zero.
void fdct_quantize(const float in[64], const int q[64], int out[64]) {
  const Dct &d = dct();
  float tmp[64];
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      float s = 0.f;
      for (int x = 0; x < 8; ++x) s += d.c[u][x] * in[y * 8 + x];
      tmp[y * 8 + u] = s;
    }
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      float s = 0.f;
      for (int y = 0; y < 8; ++y) s += d.c[v][y] * tmp[y * 8 + u];
      out[v * 8 + u] = static_cast<int>(std::lround(s / static_cast<float>(q[v * 8 + u])));
    }
}

// Magnitude category of a coefficient (its bit count).
inline int category(int v) {
  int a = v < 0 ? -v : v, n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

void encode_block(BitWriter &bw, const int coef[64], int *prev_dc, const HuffCodes &dc,
                  const HuffCodes &ac) {
  const int diff = coef[0] - *prev_dc;
  *prev_dc = coef[0];
  int n = category(diff);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = coef[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {  // ZRL
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = category(v);
    const int sym = (run << 4) | n;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0x00], ac.size[0x00]);  // EOB
}

void marker(Bytes &o, uint8_t m) {
  o.push_back(0xFF);
  o.push_back(m);
}

void word(Bytes &o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void write_dht(Bytes &o, int cls_id, const uint8_t bits[16], const uint8_t *vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  marker(o, 0xC4);
  word(o, 2 + 1 + 16 + n);
  o.push_back(static_cast<uint8_t>(cls_id));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

// libjpeg's rgb_ycc_convert: 16-bit fixed point, rounded (Cb/Cr with the
// bias of ONE_HALF - 1 that keeps them below 256).
struct YccTables {
  int32_t t[8][256];  // R_Y G_Y B_Y R_CB G_CB B_CR=B_CB R_CR G_CR B_CR
  YccTables() {
    const auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
    const int32_t half = 1 << 15, cbcr_offset = 128 << 16;
    for (int i = 0; i < 256; ++i) {
      t[0][i] = fix(0.29900) * i;
      t[1][i] = fix(0.58700) * i;
      t[2][i] = fix(0.11400) * i + half;
      t[3][i] = -fix(0.16874) * i;
      t[4][i] = -fix(0.33126) * i;
      t[5][i] = fix(0.50000) * i + cbcr_offset + half - 1;  // B -> Cb, R -> Cr
      t[6][i] = -fix(0.41869) * i;
      t[7][i] = -fix(0.08131) * i;
    }
  }
};

const YccTables &ycc() {
  static const YccTables t;
  return t;
}

bool encode(const uint8_t *rgb, int w, int h, int quality, Bytes *out) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535) return false;
  const YccTables &T = ycc();
  // MCU-padded planes: luma to multiples of 16, chroma to multiples of 8.
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int pw = mcux * 16, ph = mcuy * 16, cw = pw / 2, ch = ph / 2;
  std::vector<uint8_t> Y(static_cast<size_t>(pw) * ph), Cb(Y.size()), Cr(Y.size());
  for (int y = 0; y < ph; ++y) {
    const int sy = y < h ? y : h - 1;  // repeat the last row
    for (int x = 0; x < pw; ++x) {
      const int sx = x < w ? x : w - 1;  // repeat the last column
      const uint8_t *p = rgb + (static_cast<size_t>(sy) * w + sx) * 3;
      const int r = p[0], g = p[1], b = p[2];
      const size_t o = static_cast<size_t>(y) * pw + x;
      Y[o] = static_cast<uint8_t>((T.t[0][r] + T.t[1][g] + T.t[2][b]) >> 16);
      Cb[o] = static_cast<uint8_t>((T.t[3][r] + T.t[4][g] + T.t[5][b]) >> 16);
      Cr[o] = static_cast<uint8_t>((T.t[5][r] + T.t[6][g] + T.t[7][b]) >> 16);
    }
  }
  // h2v2_downsample: (a + b + c + d + bias) >> 2, bias 1, 2, 1, 2, ... along a row.
  std::vector<uint8_t> Cbs(static_cast<size_t>(cw) * ch), Crs(Cbs.size());
  for (int y = 0; y < ch; ++y) {
    int bias = 1;
    for (int x = 0; x < cw; ++x) {
      const size_t a = static_cast<size_t>(2 * y) * pw + 2 * x, b = a + pw;
      Cbs[static_cast<size_t>(y) * cw + x] =
          static_cast<uint8_t>((Cb[a] + Cb[a + 1] + Cb[b] + Cb[b + 1] + bias) >> 2);
      Crs[static_cast<size_t>(y) * cw + x] =
          static_cast<uint8_t>((Cr[a] + Cr[a + 1] + Cr[b] + Cr[b + 1] + bias) >> 2);
      bias ^= 3;
    }
  }
  int ql[64], qc[64];
  scaled_table(kLumaQuant, quality, ql);
  scaled_table(kChromaQuant, quality, qc);

  Bytes &o = *out;
  o.clear();
  o.reserve(static_cast<size_t>(w) * h / 2 + 1024);
  marker(o, 0xD8);  // SOI
  marker(o, 0xE0);  // APP0 JFIF 1.01, no density unit, 1:1
  word(o, 16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), jfif, jfif + 14);
  for (int t = 0; t < 2; ++t) {  // DQT, zigzag order
    marker(o, 0xDB);
    word(o, 67);
    o.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) o.push_back(static_cast<uint8_t>((t ? qc : ql)[kZigzag[k]]));
  }
  marker(o, 0xC0);  // SOF0
  word(o, 17);
  o.push_back(8);
  word(o, h);
  word(o, w);
  o.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + 9);
  write_dht(o, 0x00, kDcLumaBits, kDcLumaVals);
  write_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  write_dht(o, 0x01, kDcChromaBits, kDcChromaVals);
  write_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  marker(o, 0xDA);  // SOS
  word(o, 12);
  o.push_back(3);
  const uint8_t scan[9] = {1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  o.insert(o.end(), scan, scan + 9);

  static const HuffCodes dcl = derive(kDcLumaBits, kDcLumaVals);
  static const HuffCodes acl = derive(kAcLumaBits, kAcLumaVals);
  static const HuffCodes dcc = derive(kDcChromaBits, kDcChromaVals);
  static const HuffCodes acc = derive(kAcChromaBits, kAcChromaVals);
  BitWriter bw(&o);
  int dc_y = 0, dc_cb = 0, dc_cr = 0;
  float block[64];
  int coef[64];
  const auto load = [&block](const std::vector<uint8_t> &plane, int stride, int x0, int y0) {
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        block[y * 8 + x] = static_cast<float>(plane[static_cast<size_t>(y0 + y) * stride + x0 + x]) - 128.f;
  };
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          load(Y, pw, mx * 16 + bx * 8, my * 16 + by * 8);
          fdct_quantize(block, ql, coef);
          encode_block(bw, coef, &dc_y, dcl, acl);
        }
      load(Cbs, cw, mx * 8, my * 8);
      fdct_quantize(block, qc, coef);
      encode_block(bw, coef, &dc_cb, dcc, acc);
      load(Crs, cw, mx * 8, my * 8);
      fdct_quantize(block, qc, coef);
      encode_block(bw, coef, &dc_cr, dcc, acc);
    }
  bw.flush();
  marker(o, 0xD9);  // EOI
  return true;
}

}  // namespace

extern "C" {

// Encode a w x h RGB8 image (rows packed) at quality 1..100. Returns the
// byte count and sets *out to a malloc'd buffer the caller releases with
// frt_jpeg_free; returns 0 for an empty or oversized image.
long frt_encode_jpeg(const uint8_t *rgb, int w, int h, int quality, uint8_t **out) {
  *out = nullptr;
  Bytes bytes;
  if (!encode(rgb, w, h, quality, &bytes)) return 0;
  *out = static_cast<uint8_t *>(malloc(bytes.size()));
  if (!*out) return 0;
  memcpy(*out, bytes.data(), bytes.size());
  return static_cast<long>(bytes.size());
}

void frt_jpeg_free(uint8_t *ptr) { free(ptr); }

}  // extern "C"
