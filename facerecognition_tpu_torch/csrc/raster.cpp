// Host rasterisation and resampling for the procedural face renderer
// (training/synthetic_faces.py, training/ood_faces.py).
//
// Each function is the port's counterpart of one OpenCV 5 call the JAX
// package's renderer makes, on C-contiguous float32 or float64 HWC images
// (1 or 3 channels), drawing in place or writing a caller-allocated output:
//
// - frt_draw_list (ellipse / fillPoly / line / rectangle / circle, a list of
//   calls run in order): OpenCV's integer rasterisers (8-connected, no
//   anti-aliasing). Angles are rounded to whole degrees; an ellipse is a
//   polygon from a float table of sines at whole degrees (step 90/30/18/5
//   by the larger axis) at 16 fractional bits, filled convex for a full
//   turn, by an edge list with the centre for an arc, outlined by thick
//   segments (a quad and round caps; a thin outline's points rounded to
//   pixels and joined 8-connected, as OpenCV 5 draws it). The edge list
//   fills from the ceiling of the left edge to the floor of the right one,
//   edges that leave the image clipped to it first (OpenCV 5). A colour is
//   stored in the pixel type; a 1-channel image takes its first
//   component. Bit for bit wherever the renderer draws; ROADMAP.md lists
//   the fills that cross the image's border otherwise.
// - gaussian_blur: OpenCV's kernel (size cvRound(8 sigma + 1) | 1,
//   computed in double, cast to the pixel type), separable, reflect-101
//   border; the summation order is this file's.
// - resize_cubic: OpenCV's INTER_CUBIC (A = -0.75, half-pixel centres,
//   replicated border) on float32.
// - rotation_matrix: getRotationMatrix2D in double (std::cos, std::sin).
// - warp_affine: warpAffine INTER_LINEAR with a constant 0 border. float32
//   as OpenCV 5 computes it: the matrix inverted in double and cast to
//   float, the source position of (x, y) as fma(m0, x, float(y*m1 + m2)),
//   weights from the position's fraction, two lerps in x and one in y,
//   each an fma. float64 as its older path: positions in fixed point
//   rounded to 1/32, weights from the 32 x 32 float table.
// - estimate_affine_partial: estimateAffinePartial2D's RANSAC (OpenCV's
//   generator and seed, its two-point kernel, float errors against a 3 px
//   threshold, its iteration update), then the least-squares similarity on
//   the inliers in closed form where OpenCV refines by Levenberg-Marquardt.
//
// Nothing holds state: every call may run from any thread. Loaded with
// ctypes (training/raster.py), which releases the GIL for the call. No
// implicit fma contraction (the pragma below); the float32 warp's fmas are
// explicit. Build:
//   g++ -O3 -std=c++17 -shared -fPIC raster.cpp

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#pragma GCC optimize("fp-contract=off")

namespace {

typedef int64_t i64;

constexpr int XY_SHIFT = 16;
constexpr i64 XY_ONE = i64(1) << XY_SHIFT;

struct Pt {
  i64 x, y;
  bool operator!=(const Pt& o) const { return x != o.x || y != o.y; }
};

// cvRound: round half to even (the SSE conversion OpenCV uses).
inline int round_even(double v) { return (int)std::nearbyint(v); }

// An image drawn in place: float32 or float64 pixels of cn channels; each
// put stores the colour's bytes, as OpenCV's drawing does.
struct Canvas {
  unsigned char* d;
  int h, w;
  size_t pix;
  unsigned char c[32];
  Canvas(void* data, int h_, int w_, int cn, bool f64, const double* color)
      : d((unsigned char*)data), h(h_), w(w_), pix((size_t)cn * (f64 ? 8 : 4)) {
    for (int k = 0; k < cn; ++k) {
      if (f64) {
        std::memcpy(c + 8 * k, &color[k], 8);
      } else {
        float v = (float)color[k];
        std::memcpy(c + 4 * k, &v, 4);
      }
    }
  }
  inline void put(int x, int y) { std::memcpy(d + ((size_t)y * w + x) * pix, c, pix); }
  template <size_t N>
  inline void fill_n(unsigned char* p, int n) {
    for (int i = 0; i < n; ++i, p += N) std::memcpy(p, c, N);
  }
  inline void hline(int y, int x1, int x2) {
    unsigned char* p = d + ((size_t)y * w + x1) * pix;
    int n = x2 - x1 + 1;
    switch (pix) {
      case 4: fill_n<4>(p, n); break;
      case 8: fill_n<8>(p, n); break;
      case 12: fill_n<12>(p, n); break;
      case 24: fill_n<24>(p, n); break;
      default:
        for (int i = 0; i < n; ++i, p += pix) std::memcpy(p, c, pix);
    }
  }
};

// sin of 0..450 whole degrees, rounded to 7 decimals and then to float.
struct SinTable {
  float v[451];
  SinTable() {
    for (int i = 0; i <= 450; ++i) {
      double s = std::sin(i * (M_PI / 180.0));
      v[i] = (float)(std::nearbyint(s * 1e7) / 1e7);
    }
  }
};
const SinTable& sin_table() {
  static const SinTable t;
  return t;
}

bool clip_line(i64 width, i64 height, Pt& pt1, Pt& pt2) {
  i64 right = width - 1, bottom = height - 1;
  if (width <= 0 || height <= 0) return false;
  i64 &x1 = pt1.x, &y1 = pt1.y, &x2 = pt2.x, &y2 = pt2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    i64 a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (i64)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (i64)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (i64)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (i64)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// 8-connected Bresenham line between pixel centres, left to right, clipped.
void line8(Canvas& img, Pt p1, Pt p2) {
  if ((uint64_t)p1.x >= (uint64_t)img.w || (uint64_t)p2.x >= (uint64_t)img.w ||
      (uint64_t)p1.y >= (uint64_t)img.h || (uint64_t)p2.y >= (uint64_t)img.h) {
    if (!clip_line(img.w, img.h, p1, p2)) return;
  }
  int x1 = (int)p1.x, y1 = (int)p1.y, x2 = (int)p2.x, y2 = (int)p2.y;
  int delta_x = 1, delta_y = 1;
  int dx = x2 - x1, dy = y2 - y1;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(x1, x2);
    std::swap(y1, y2);
  }
  if (dy < 0) {
    dy = -dy;
    delta_y = -1;
  }
  bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int err = dx - (dy + dy);
  int plus_delta = dx + dx, minus_delta = -(dy + dy);
  int minus_shift = delta_x, plus_shift = 0, minus_step = 0, plus_step = delta_y;
  int count = dx + 1;
  if (vert) {
    std::swap(plus_step, minus_step);
    std::swap(plus_shift, minus_shift);
  }
  int x = x1, y = y1;
  for (int i = 0; i < count; ++i) {
    img.put(x, y);
    int mask = err < 0 ? -1 : 0;
    err += minus_delta + (plus_delta & mask);
    x += minus_shift + (plus_shift & mask);
    y += minus_step + (plus_step & mask);
  }
}

// Line between 16-bit fixed-point points, clipped in fixed point.
void line_fixed(Canvas& img, Pt pt1, Pt pt2) {
  if (!clip_line((i64)img.w << XY_SHIFT, (i64)img.h << XY_SHIFT, pt1, pt2)) return;
  i64 dx = pt2.x - pt1.x, dy = pt2.y - pt1.y;
  i64 j = dx < 0 ? -1 : 0;
  i64 ax = (dx ^ j) - j;
  i64 i = dy < 0 ? -1 : 0;
  i64 ay = (dy ^ i) - i;
  i64 x_step, y_step;
  int ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    pt1.x ^= pt2.x & j;
    pt2.x ^= pt1.x & j;
    pt1.x ^= pt2.x & j;
    pt1.y ^= pt2.y & j;
    pt2.y ^= pt1.y & j;
    pt1.y ^= pt2.y & j;
    x_step = XY_ONE;
    y_step = dy * (1 << XY_SHIFT) / (ax | 1);
    ecount = (int)((pt2.x - pt1.x) >> XY_SHIFT);
  } else {
    dx = (dx ^ i) - i;
    pt1.x ^= pt2.x & i;
    pt2.x ^= pt1.x & i;
    pt1.x ^= pt2.x & i;
    pt1.y ^= pt2.y & i;
    pt2.y ^= pt1.y & i;
    pt1.y ^= pt2.y & i;
    x_step = dx * (1 << XY_SHIFT) / (ay | 1);
    y_step = XY_ONE;
    ecount = (int)((pt2.y - pt1.y) >> XY_SHIFT);
  }
  pt1.x += XY_ONE >> 1;
  pt1.y += XY_ONE >> 1;
  auto put = [&](i64 x, i64 y) {
    if (0 <= x && x < img.w && 0 <= y && y < img.h) img.put((int)x, (int)y);
  };
  put((pt2.x + (XY_ONE >> 1)) >> XY_SHIFT, (pt2.y + (XY_ONE >> 1)) >> XY_SHIFT);
  if (ax > ay) {
    pt1.x >>= XY_SHIFT;
    while (ecount >= 0) {
      put(pt1.x, pt1.y >> XY_SHIFT);
      pt1.x++;
      pt1.y += y_step;
      ecount--;
    }
  } else {
    pt1.y >>= XY_SHIFT;
    while (ecount >= 0) {
      put(pt1.x >> XY_SHIFT, pt1.y);
      pt1.x += x_step;
      pt1.y++;
      ecount--;
    }
  }
}

void fill_convex(Canvas& img, const Pt* v, int npts, int shift) {
  struct {
    int idx, di;
    i64 x, dx;
    int ye;
  } edge[2];
  int delta = 1 << shift >> 1;
  int i, y, imin = 0;
  int edges = npts;
  i64 xmin, xmax, ymin, ymax;
  const i64 delta1 = XY_ONE >> 1, delta2 = XY_ONE >> 1;
  Pt p0 = v[npts - 1];
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  xmin = xmax = v[0].x;
  ymin = ymax = v[0].y;
  for (i = 0; i < npts; i++) {
    Pt p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    p.x <<= XY_SHIFT - shift;
    p.y <<= XY_SHIFT - shift;
    if (shift == 0) {
      line8(img, Pt{p0.x >> XY_SHIFT, p0.y >> XY_SHIFT}, Pt{p.x >> XY_SHIFT, p.y >> XY_SHIFT});
    } else {
      line_fixed(img, p0, p);
    }
    p0 = p;
  }
  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;
  if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= img.w || (int)ymin >= img.h) return;
  ymax = std::min<i64>(ymax, img.h - 1);
  edge[0].idx = edge[1].idx = imin;
  edge[0].ye = edge[1].ye = y = (int)ymin;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -XY_ONE;
  edge[0].dx = edge[1].dx = 0;
  do {
    for (i = 0; i < 2; i++) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        int ty = 0;
        for (; edges-- > 0;) {
          ty = (int)((v[idx].y + delta) >> shift);
          if (ty > y) {
            i64 xs = v[idx0].x;
            i64 xe = v[idx].x;
            if (shift != XY_SHIFT) {
              xs <<= XY_SHIFT - shift;
              xe <<= XY_SHIFT - shift;
            }
            edge[i].ye = ty;
            edge[i].dx = ((xe - xs) * 2 + ((i64)ty - y)) / (2 * ((i64)ty - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) left = 1, right = 0;
      int xx1 = (int)((edge[left].x + delta1) >> XY_SHIFT);
      int xx2 = (int)((edge[right].x + delta2) >> XY_SHIFT);
      if (xx2 >= 0 && xx1 < img.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= img.w) xx2 = img.w - 1;
        img.hline(y, xx1, xx2);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= (int)ymax);
}

struct PolyEdge {
  int y0, y1;
  i64 x, dx;
  PolyEdge* next;
};

void collect_edges(Canvas& img, const Pt* v, int count, std::vector<PolyEdge>& edges, int shift) {
  int i, delta = (1 << shift) >> 1;
  Pt pt0 = v[count - 1], pt1;
  pt0.x = pt0.x << (XY_SHIFT - shift);
  pt0.y = (pt0.y + delta) >> shift;
  for (i = 0; i < count; i++, pt0 = pt1) {
    PolyEdge edge;
    pt1 = v[i];
    pt1.x = pt1.x << (XY_SHIFT - shift);
    pt1.y = (pt1.y + delta) >> shift;
    Pt pt0c = pt0, pt1c = pt1;
    Pt t0{(pt0.x + (XY_ONE >> 1)) >> XY_SHIFT, pt0.y};
    Pt t1{(pt1.x + (XY_ONE >> 1)) >> XY_SHIFT, pt1.y};
    line8(img, t0, t1);
    if ((uint64_t)t0.x >= (uint64_t)img.w || (uint64_t)t1.x >= (uint64_t)img.w || (uint64_t)t0.y >= (uint64_t)img.h ||
        (uint64_t)t1.y >= (uint64_t)img.h) {
      clip_line(img.w, img.h, t0, t1);
      if (t0.y != t1.y) {
        pt0c.y = t0.y;
        pt1c.y = t1.y;
        pt0c.x = t0.x << XY_SHIFT;
        pt1c.x = t1.x << XY_SHIFT;
      }
    } else {
      pt0c.x += XY_ONE >> 1;
      pt1c.x += XY_ONE >> 1;
    }
    if (pt0.y == pt1.y) continue;
    edge.dx = (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
    if (pt0.y < pt1.y) {
      edge.y0 = (int)pt0.y;
      edge.y1 = (int)pt1.y;
      edge.x = pt0c.x + (pt0.y - pt0c.y) * edge.dx;
    } else {
      edge.y0 = (int)pt1.y;
      edge.y1 = (int)pt0.y;
      edge.x = pt1c.x + (pt1.y - pt1c.y) * edge.dx;
    }
    edge.next = nullptr;
    edges.push_back(edge);
  }
}

void fill_edges(Canvas& img, std::vector<PolyEdge>& edges) {
  PolyEdge tmp;
  int i, y, total = (int)edges.size();
  PolyEdge* e;
  int y_max = INT_MIN, y_min = INT_MAX;
  i64 x_max = (i64)0xFFFFFFFFFFFFFFFF, x_min = (i64)0x7FFFFFFFFFFFFFFF;
  const i64 delta1 = (XY_ONE >> 1) - 1, delta2 = -(XY_ONE >> 1);
  if (total < 2) return;
  for (i = 0; i < total; i++) {
    PolyEdge& e1 = edges[i];
    i64 x1 = e1.x + (e1.y1 - e1.y0) * e1.dx;
    y_min = std::min(y_min, e1.y0);
    y_max = std::max(y_max, e1.y1);
    x_min = std::min(x_min, e1.x);
    x_max = std::max(x_max, e1.x);
    x_min = std::min(x_min, x1);
    x_max = std::max(x_max, x1);
  }
  if (y_max < 0 || y_min >= img.h || x_max < 0 || x_min >= ((i64)img.w << XY_SHIFT)) return;
  std::sort(edges.begin(), edges.end(), [](const PolyEdge& e1, const PolyEdge& e2) {
    return e1.y0 - e2.y0 ? e1.y0 < e2.y0 : e1.x - e2.x ? e1.x < e2.x : e1.dx < e2.dx;
  });
  tmp.y0 = INT_MAX;
  edges.push_back(tmp);
  i = 0;
  tmp.next = nullptr;
  e = &edges[i];
  y_max = std::min(y_max, img.h);
  for (y = e->y0; y < y_max; y++) {
    PolyEdge *last, *prelast, *keep_prelast;
    int draw = 0;
    int clipline = y < 0;
    prelast = &tmp;
    last = tmp.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int x1, x2;
          if (keep_prelast->x > prelast->x) {
            x1 = (int)((prelast->x + delta1) >> XY_SHIFT);
            x2 = (int)((keep_prelast->x + delta2) >> XY_SHIFT);
          } else {
            x1 = (int)((keep_prelast->x + delta1) >> XY_SHIFT);
            x2 = (int)((prelast->x + delta2) >> XY_SHIFT);
          }
          if (x1 < img.w && x2 >= 0) {
            if (x1 < 0) x1 = 0;
            if (x2 >= img.w) x2 = img.w - 1;
            img.hline(y, x1, x2);
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    keep_prelast = nullptr;
    do {
      prelast = &tmp;
      last = tmp.next;
      PolyEdge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        PolyEdge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

// Midpoint circle; filled spans or outline points, clipped.
void circle_int(Canvas& img, int cx, int cy, int radius, bool fill) {
  int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  auto span = [&](int y, int x1, int x2) {
    if ((unsigned)y >= (unsigned)img.h) return;
    if (fill) {
      x1 = std::max(x1, 0);
      x2 = std::min(x2, img.w - 1);
      if (x1 <= x2) img.hline(y, x1, x2);
    } else {
      if ((unsigned)x1 < (unsigned)img.w) img.put(x1, y);
      if ((unsigned)x2 < (unsigned)img.w) img.put(x2, y);
    }
  };
  while (dx >= dy) {
    int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (x11 < img.w && x12 >= 0 && y21 < img.h && y22 >= 0) {
      span(y11, x11, x12);
      span(y12, x11, x12);
      if (x21 < img.w && x22 >= 0) {
        span(y21, x21, x22);
        span(y22, x21, x22);
      }
    }
    dy++;
    err += plus;
    plus += 2;
    int mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

void ellipse_ex(Canvas& img, Pt center, Pt axes, int angle, int arc_start, int arc_end, int thickness);

void thick_line(Canvas& img, Pt p0, Pt p1, int thickness, int flags, int shift) {
  const double INV_XY_ONE = 1. / XY_ONE;
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  p1.x <<= XY_SHIFT - shift;
  p1.y <<= XY_SHIFT - shift;
  if (thickness <= 1) {  // OpenCV 5 rounds the ends to pixels and draws 8-connected
    p0.x = (p0.x + (XY_ONE >> 1)) >> XY_SHIFT;
    p0.y = (p0.y + (XY_ONE >> 1)) >> XY_SHIFT;
    p1.x = (p1.x + (XY_ONE >> 1)) >> XY_SHIFT;
    p1.y = (p1.y + (XY_ONE >> 1)) >> XY_SHIFT;
    line8(img, p0, p1);
    return;
  }
  Pt pt[4], dp{0, 0};
  double dx = (p0.x - p1.x) * INV_XY_ONE, dy = (p1.y - p0.y) * INV_XY_ONE;
  double r = dx * dx + dy * dy;
  int odd = thickness & 1;
  thickness <<= XY_SHIFT - 1;
  if (std::fabs(r) > 2.2204460492503131e-16) {
    r = (thickness + odd * XY_ONE * 0.5) / std::sqrt(r);
    dp.x = round_even(dy * r);
    dp.y = round_even(dx * r);
    pt[0] = Pt{p0.x + dp.x, p0.y + dp.y};
    pt[1] = Pt{p0.x - dp.x, p0.y - dp.y};
    pt[2] = Pt{p1.x - dp.x, p1.y - dp.y};
    pt[3] = Pt{p1.x + dp.x, p1.y + dp.y};
    fill_convex(img, pt, 4, XY_SHIFT);
  }
  for (int i = 0; i < 2; i++) {
    if (flags & (i + 1)) {
      int cx = (int)((p0.x + (XY_ONE >> 1)) >> XY_SHIFT);
      int cy = (int)((p0.y + (XY_ONE >> 1)) >> XY_SHIFT);
      circle_int(img, cx, cy, (int)((thickness + (XY_ONE >> 1)) >> XY_SHIFT), true);
    }
    p0 = p1;
  }
}

void poly_line(Canvas& img, const Pt* v, int count, bool closed, int thickness, int shift) {
  if (!v || count <= 0) return;
  int i = closed ? count - 1 : 0;
  int flags = 2 + !closed;
  Pt p0 = v[i];
  for (i = !closed; i < count; i++) {
    Pt p = v[i];
    thick_line(img, p0, p, thickness, flags, shift);
    p0 = p;
    flags = 2;
  }
}

void ellipse_poly(double cx, double cy, double aw, double ah, int angle, int arc_start, int arc_end, int delta,
                  std::vector<double>& pts) {
  const float* tab = sin_table().v;
  while (angle < 0) angle += 360;
  while (angle > 360) angle -= 360;
  if (arc_start > arc_end) std::swap(arc_start, arc_end);
  while (arc_start < 0) {
    arc_start += 360;
    arc_end += 360;
  }
  while (arc_end > 360) {
    arc_end -= 360;
    arc_start -= 360;
  }
  if (arc_end - arc_start > 360) {
    arc_start = 0;
    arc_end = 360;
  }
  int a = angle + (angle < 0 ? 360 : 0);
  float beta = tab[a], alpha = tab[450 - a];
  pts.clear();
  for (int i = arc_start; i < arc_end + delta; i += delta) {
    int ang = i;
    if (ang > arc_end) ang = arc_end;
    if (ang < 0) ang += 360;
    double x = aw * tab[450 - ang];
    double y = ah * tab[ang];
    pts.push_back(cx + x * alpha - y * beta);
    pts.push_back(cy + x * beta + y * alpha);
  }
  if (pts.size() == 2) {
    pts.assign({cx, cy, cx, cy});
  }
}

void ellipse_ex(Canvas& img, Pt center, Pt axes, int angle, int arc_start, int arc_end, int thickness) {
  axes.x = std::llabs(axes.x), axes.y = std::llabs(axes.y);
  int delta = (int)((std::max(axes.x, axes.y) + (XY_ONE >> 1)) >> XY_SHIFT);
  delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
  std::vector<double> dv;
  ellipse_poly((double)center.x, (double)center.y, (double)axes.x, (double)axes.y, angle, arc_start, arc_end, delta,
               dv);
  std::vector<Pt> v;
  Pt prev{(i64)0xFFFFFFFFFFFFFFFF, (i64)0xFFFFFFFFFFFFFFFF};
  for (size_t i = 0; i < dv.size(); i += 2) {
    Pt pt;
    pt.x = (i64)round_even(dv[i] / XY_ONE) << XY_SHIFT;
    pt.y = (i64)round_even(dv[i + 1] / XY_ONE) << XY_SHIFT;
    pt.x += round_even(dv[i] - pt.x);
    pt.y += round_even(dv[i + 1] - pt.y);
    if (pt != prev) {
      v.push_back(pt);
      prev = pt;
    }
  }
  if (v.size() == 1) v.assign(2, center);
  if (thickness >= 0) {
    poly_line(img, v.data(), (int)v.size(), false, thickness, XY_SHIFT);
  } else if (arc_end - arc_start >= 360) {
    fill_convex(img, v.data(), (int)v.size(), XY_SHIFT);
  } else {
    v.push_back(center);
    std::vector<PolyEdge> edges;
    edges.reserve(v.size() + 1);
    collect_edges(img, v.data(), (int)v.size(), edges, XY_SHIFT);
    fill_edges(img, edges);
  }
}

inline int reflect101(int p, int n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) {
    if (p < 0) p = -p;
    if (p >= n) p = 2 * n - 2 - p;
  }
  return p;
}

// Narrows [x0, x1] to the x where lo <= m0 * x + c < hi, widened by 2 px
// for the rounding of the exact test, which still runs on every x kept.
inline void row_span(double m0, double c, double lo, double hi, int& x0, int& x1) {
  if (std::fabs(m0) < 1e-9) {
    if (!(c >= lo - 1 && c < hi + 1)) x1 = x0 - 1;
    return;
  }
  double a = (lo - c) / m0, b = (hi - c) / m0;
  if (a > b) std::swap(a, b);
  double fa = std::max(std::floor(a) - 2, (double)x0), fb = std::min(std::ceil(b) + 2, (double)x1);
  if (fa > fb) {
    x1 = x0 - 1;
  } else {
    x0 = (int)fa;
    x1 = (int)fb;
  }
}

// The float32 warp's rows, CN channels (0: cn at run time); FMA is fmaf, a
// hardware instruction in warp_rows_hw (compiled for FMA, taken where the
// CPU has it). Each row runs the exact test only over the span whose
// sample positions can fall near the source; the rest is the border, 0.
#define FRT_WARP_ROWS(FMA)                                                             \
  const int C = CN ? CN : cn;                                                          \
  for (int y = 0; y < dh; ++y) {                                                       \
    float mx = (float)((float)y * m[1] + m[2]);                                        \
    float my = (float)((float)y * m[4] + m[5]);                                        \
    float* row = dst + (size_t)y * dw * C;                                             \
    int xa = 0, xb = dw - 1;                                                           \
    row_span(m[0], mx, -1.0, sw, xa, xb);                                              \
    row_span(m[3], my, -1.0, sh, xa, xb);                                              \
    if (xb < xa) {                                                                     \
      std::fill(row, row + (size_t)dw * C, 0.f);                                       \
      continue;                                                                        \
    }                                                                                  \
    std::fill(row, row + (size_t)xa * C, 0.f);                                         \
    std::fill(row + (size_t)(xb + 1) * C, row + (size_t)dw * C, 0.f);                  \
    float* out = row + (size_t)xa * C;                                                 \
    for (int x = xa; x <= xb; ++x, out += C) {                                         \
      float fx = (float)x;                                                             \
      float sx = FMA(m[0], fx, mx);                                                    \
      float sy = FMA(m[3], fx, my);                                                    \
      float flx = std::floor(sx), fly = std::floor(sy);                                \
      if (!(flx > -2.f && flx < (float)sw && fly > -2.f && fly < (float)sh)) {         \
        for (int k = 0; k < C; ++k) out[k] = 0.f;                                      \
        continue;                                                                      \
      }                                                                                \
      int ix = (int)flx, iy = (int)fly;                                                \
      float a = sx - (float)ix, b = sy - (float)iy;                                    \
      const float* r0 = src + ((ptrdiff_t)iy * sw + ix) * C;                           \
      const float* r1 = r0 + (size_t)sw * C;                                           \
      if (ix >= 0 && ix + 1 < sw && iy >= 0 && iy + 1 < sh) {                          \
        for (int k = 0; k < C; ++k) {                                                  \
          float p00 = r0[k], p01 = r0[C + k], p10 = r1[k], p11 = r1[C + k];            \
          float v0 = FMA(a, p01 - p00, p00);                                           \
          float v1 = FMA(a, p11 - p10, p10);                                           \
          out[k] = FMA(b, v1 - v0, v0);                                                \
        }                                                                              \
        continue;                                                                      \
      }                                                                                \
      bool x0 = ix >= 0, x1 = ix + 1 < sw, y0 = iy >= 0, y1 = iy + 1 < sh;             \
      for (int k = 0; k < C; ++k) {                                                    \
        float p00 = (y0 && x0) ? r0[k] : 0.f;                                          \
        float p01 = (y0 && x1) ? r0[C + k] : 0.f;                                      \
        float p10 = (y1 && x0) ? r1[k] : 0.f;                                          \
        float p11 = (y1 && x1) ? r1[C + k] : 0.f;                                      \
        float v0 = FMA(a, p01 - p00, p00);                                             \
        float v1 = FMA(a, p11 - p10, p10);                                             \
        out[k] = FMA(b, v1 - v0, v0);                                                  \
      }                                                                                \
    }                                                                                  \
  }

template <int CN>
__attribute__((target("fma"))) void warp_rows_hw(const float* src, int sh, int sw, int cn, const float* m, float* dst,
                                                 int dh, int dw) {
  FRT_WARP_ROWS(__builtin_fmaf)
}

template <int CN>
void warp_rows_sw(const float* src, int sh, int sw, int cn, const float* m, float* dst, int dh, int dw) {
  FRT_WARP_ROWS(std::fmaf)
}

template <int CN>
void warp_rows(bool hw, const float* src, int sh, int sw, int cn, const float* m, float* dst, int dh, int dw) {
  if (hw)
    warp_rows_hw<CN>(src, sh, sw, cn, m, dst, dh, dw);
  else
    warp_rows_sw<CN>(src, sh, sw, cn, m, dst, dh, dw);
}

// out[i] = k[0] * taps[0][i] + k[1] * taps[1][i] + ... in that order, for
// i < m, accumulated in out tap by tap.
template <typename T>
__attribute__((always_inline)) inline void taps_sum(const T* k, int n, const T* const* taps, size_t m,
                                                    T* out) {
  const T* t0 = taps[0];
  for (size_t i = 0; i < m; ++i) out[i] = k[0] * t0[i];
  for (int t = 1; t < n; ++t) {
    const T* tt = taps[t];
    const T kt = k[t];
    for (size_t i = 0; i < m; ++i) out[i] += kt * tt[i];
  }
}

template <typename T>
__attribute__((always_inline)) inline void blur_rows_cols(const T* src, T* dst, int h, int w, int cn, const double* kd, int n) {
  std::vector<T> kb(kd, kd + n);
  int r = n / 2;
  size_t m = (size_t)w * cn;
  std::vector<T> tmp((size_t)h * m), pad((size_t)(w + 2 * r) * cn);
  std::vector<int> xo(w + 2 * r);
  for (int i = -r; i < w + r; ++i) xo[i + r] = reflect101(i, w);
  std::vector<const T*> taps(n);
  // Rows: each row padded by reflection, then each output is k[0] * tap 0 +
  // k[1] * tap 1 + ... in that order; columns the same over the rows'
  // results (reflect-101 rows).
  for (int y = 0; y < h; ++y) {
    const T* row = src + (size_t)y * m;
    for (int i = 0; i < w + 2 * r; ++i)
      for (int c = 0; c < cn; ++c) pad[(size_t)i * cn + c] = row[xo[i] * cn + c];
    for (int t = 0; t < n; ++t) taps[t] = pad.data() + (size_t)t * cn;
    taps_sum(kb.data(), n, taps.data(), m, tmp.data() + (size_t)y * m);
  }
  for (int y = 0; y < h; ++y) {
    for (int t = 0; t < n; ++t) taps[t] = tmp.data() + (size_t)reflect101(y - r + t, h) * m;
    taps_sum(kb.data(), n, taps.data(), m, dst + (size_t)y * m);
  }
}

// OpenCV's warpAffine for float64 pixels: sample positions in fixed point
// (10 fractional bits rounded to 5), bilinear weights from the 32 x 32
// float table, summed in double.
void warp_rows_f64(const double* src, int sh, int sw, int cn, const double* M, double* dst, int dh, int dw) {
  const int AB_BITS = 10, AB_SCALE = 1 << AB_BITS, INTER_BITS = 5, TAB = 1 << INTER_BITS;
  const int round_delta = AB_SCALE / TAB / 2;
  float tab1[TAB][2];
  for (int i = 0; i < TAB; ++i) {
    float x = i * 1.f / TAB;
    tab1[i][0] = 1.f - x;
    tab1[i][1] = x;
  }
  std::vector<int> adelta(dw), bdelta(dw);
  for (int x = 0; x < dw; ++x) {
    adelta[x] = round_even(M[0] * x * AB_SCALE);
    bdelta[x] = round_even(M[3] * x * AB_SCALE);
  }
  auto clamp_short = [](int v) { return std::min(std::max(v, -32768), 32767); };
  for (int y = 0; y < dh; ++y) {
    int X0 = round_even((M[1] * y + M[2]) * AB_SCALE) + round_delta;
    int Y0 = round_even((M[4] * y + M[5]) * AB_SCALE) + round_delta;
    double* out = dst + (size_t)y * dw * cn;
    for (int x = 0; x < dw; ++x, out += cn) {
      int X = (X0 + adelta[x]) >> (AB_BITS - INTER_BITS);
      int Y = (Y0 + bdelta[x]) >> (AB_BITS - INTER_BITS);
      int sx = clamp_short(X >> INTER_BITS), sy = clamp_short(Y >> INTER_BITS);
      int fx = X & (TAB - 1), fy = Y & (TAB - 1);
      float w[4] = {tab1[fy][0] * tab1[fx][0], tab1[fy][0] * tab1[fx][1], tab1[fy][1] * tab1[fx][0],
                    tab1[fy][1] * tab1[fx][1]};
      bool x0 = sx >= 0 && sx < sw, x1 = sx + 1 >= 0 && sx + 1 < sw;
      bool y0 = sy >= 0 && sy < sh, y1 = sy + 1 >= 0 && sy + 1 < sh;
      if (!((x0 || x1) && (y0 || y1))) {
        for (int k = 0; k < cn; ++k) out[k] = 0.;
        continue;
      }
      for (int k = 0; k < cn; ++k) {
        double p00 = (y0 && x0) ? src[((size_t)sy * sw + sx) * cn + k] : 0.;
        double p01 = (y0 && x1) ? src[((size_t)sy * sw + sx + 1) * cn + k] : 0.;
        double p10 = (y1 && x0) ? src[((size_t)(sy + 1) * sw + sx) * cn + k] : 0.;
        double p11 = (y1 && x1) ? src[((size_t)(sy + 1) * sw + sx + 1) * cn + k] : 0.;
        out[k] = p00 * w[0] + p01 * w[1] + p10 * w[2] + p11 * w[3];
      }
    }
  }
}

// OpenCV's generator (multiply-with-carry) for RANSAC's subsets.
struct CvRng {
  uint64_t state;
  explicit CvRng(uint64_t s) : state(s ? s : 0xffffffff) {}
  unsigned next() {
    state = (uint64_t)(unsigned)state * 4164903690U + (unsigned)(state >> 32);
    return (unsigned)state;
  }
  int uniform(int a, int b) { return a == b ? a : (int)(next() % (unsigned)(b - a) + a); }
};

int ransac_update_iters(double p, double ep, int model_points, int max_iters) {
  p = std::min(std::max(p, 0.), 1.);
  ep = std::min(std::max(ep, 0.), 1.);
  double num = std::max(1. - p, 2.2250738585072014e-308);
  double denom = 1. - std::pow(1. - ep, model_points);
  if (denom < 2.2250738585072014e-308) return 0;
  num = std::log(num);
  denom = std::log(denom);
  return denom >= 0 || -num >= max_iters * (-denom) ? max_iters : round_even(num / denom);
}

void similarity_from_two(const float* f, const float* t, double* M) {
  double x1 = f[0], y1 = f[1], x2 = f[2], y2 = f[3];
  double X1 = t[0], Y1 = t[1], X2 = t[2], Y2 = t[3];
  double d = 1. / ((x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2));
  double S0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2));
  double S1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2));
  double S2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2) - (X1 * x2 - X2 * x1) * (x1 - x2));
  double S3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2) - (Y1 * y2 - Y2 * y1) * (y1 - y2));
  M[0] = M[4] = S0;
  M[1] = -S1;
  M[2] = S2;
  M[3] = S1;
  M[5] = S3;
}

int count_inliers(const float* from, const float* to, int n, const double* M, float thr2, unsigned char* mask) {
  float F0 = (float)M[0], F1 = (float)M[1], F2 = (float)M[2];
  float F3 = (float)M[3], F4 = (float)M[4], F5 = (float)M[5];
  int good = 0;
  for (int i = 0; i < n; ++i) {
    float fx = from[2 * i], fy = from[2 * i + 1];
    float a = F0 * fx + F1 * fy + F2 - to[2 * i];
    float b = F3 * fx + F4 * fy + F5 - to[2 * i + 1];
    float err = a * a + b * b;
    mask[i] = err <= thr2;
    good += mask[i];
  }
  return good;
}

}  // namespace

extern "C" {

// cv2.ellipse2Poly's double polygon for a fixed-point ellipse (tests).
int frt_ellipse2poly(double cx, double cy, double aw, double ah, int angle, int start, int end, int delta,
                     double* out, int cap) {
  std::vector<double> v;
  ellipse_poly(cx, cy, aw, ah, angle, start, end, delta, v);
  int n = (int)v.size() / 2;
  for (int i = 0; i < std::min(n, cap) * 2; ++i) out[i] = v[i];
  return n;
}

// A list of drawing calls, run in order: op k draws into image
// iops[12k + 1] with kind iops[12k] (0 ellipse, 1 line, 2 fill_poly,
// 3 rectangle, 4 circle), its integers in iops[12k + 2 ..] and its angle,
// start and end angles and colour in dops[8k ..]:
//   ellipse: cx, cy, ax, ay, thickness; angle, start, end, colour
//   line / rectangle: x1, y1, x2, y2, thickness; -, -, -, colour
//   fill_poly: n (<= 4), x0, y0, x1, y1, ...; -, -, -, colour
//   circle: cx, cy, radius, thickness; -, -, -, colour
// Images are described by (data, h, w, cn, f64) in data / meta[4i ..].
// Returns 0, or -1 (nothing drawn) for an unknown kind or image.
int frt_draw_list(int n_images, void* const* data, const int* meta, int n_ops, const int* iops,
                  const double* dops) {
  for (int k = 0; k < n_ops; ++k) {
    const int* a = iops + 12 * k;
    if (a[0] < 0 || a[0] > 4 || a[1] < 0 || a[1] >= n_images || (a[0] == 2 && (a[2] < 1 || a[2] > 4)))
      return -1;
  }
  for (int k = 0; k < n_ops; ++k) {
    const int* a = iops + 12 * k;
    const double* d = dops + 8 * k;
    const int* m = meta + 4 * a[1];
    Canvas c(data[a[1]], m[0], m[1], m[2], m[3] != 0, d + 3);
    switch (a[0]) {
      case 0:
        ellipse_ex(c, Pt{(i64)a[2] << XY_SHIFT, (i64)a[3] << XY_SHIFT}, Pt{(i64)a[4] << XY_SHIFT, (i64)a[5] << XY_SHIFT},
                   round_even(d[0]), round_even(d[1]), round_even(d[2]), a[6]);
        break;
      case 1:
        thick_line(c, Pt{a[2], a[3]}, Pt{a[4], a[5]}, a[6], 3, 0);
        break;
      case 2: {
        Pt v[4];
        for (int i = 0; i < a[2]; ++i) v[i] = Pt{a[3 + 2 * i], a[4 + 2 * i]};
        std::vector<PolyEdge> edges;
        edges.reserve(a[2] + 1);
        collect_edges(c, v, a[2], edges, 0);
        fill_edges(c, edges);
        break;
      }
      case 3: {
        Pt pt[4] = {{a[2], a[3]}, {a[4], a[3]}, {a[4], a[5]}, {a[2], a[5]}};
        if (a[6] >= 0)
          poly_line(c, pt, 4, true, a[6], 0);
        else
          fill_convex(c, pt, 4, 0);
        break;
      }
      case 4:
        if (a[5] > 1)
          ellipse_ex(c, Pt{(i64)a[2] << XY_SHIFT, (i64)a[3] << XY_SHIFT},
                     Pt{(i64)a[4] << XY_SHIFT, (i64)a[4] << XY_SHIFT}, 0, 0, 360, a[5]);
        else
          circle_int(c, a[2], a[3], a[4], a[5] < 0);
        break;
    }
  }
  return 0;
}

// The Gaussian kernel of cv2.GaussianBlur(img, (0, 0), sigma) for float
// images, in double; returns its size, writes at most cap taps.
int frt_gaussian_kernel(double sigma, double* out, int cap) {
  int n = round_even(sigma * 4 * 2 + 1) | 1;
  int n2 = (n - 1) / 2;
  std::vector<double> values(n2 + 1);
  double scale2 = -0.125 / (sigma * sigma);
  double sum = 0;
  for (int i = 0, x = 1 - n; i < n2; i++, x += 2) {
    double t = std::exp((double)(x * x) * scale2);
    values[i] = t;
    sum += t;
  }
  sum *= 2;
  sum += 1;
  double mul = 1. / sum;
  std::vector<double> k(n);
  for (int i = 0; i < n2; i++) k[i] = k[n - 1 - i] = values[i] * mul;
  k[n2] = mul;
  for (int i = 0; i < std::min(n, cap); ++i) out[i] = k[i];
  return n;
}

// cv2.GaussianBlur(src, (0, 0), sigma) on float32 (f64 = 0) or float64
// pixels: the kernel in the pixels' type, rows then columns, reflect-101
// border. src and dst may not overlap.
__attribute__((target_clones("avx2", "default"))) void frt_gaussian_blur(const void* src, void* dst, int h, int w,
                                                                              int cn, int f64, double sigma) {
  double k[256];
  int n = std::min(frt_gaussian_kernel(sigma, k, 256), 256);
  if (f64)
    blur_rows_cols<double>((const double*)src, (double*)dst, h, w, cn, k, n);
  else
    blur_rows_cols<float>((const float*)src, (float*)dst, h, w, cn, k, n);
}

// cv2.resize(src, (dw, dh), interpolation=INTER_CUBIC) on float32.
void frt_resize_cubic(const float* src, int sh, int sw, int cn, float* dst, int dh, int dw) {
  auto coeffs = [](float x, float* c) {
    const float A = -0.75f;
    c[0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A;
    c[1] = ((A + 2) * x - (A + 3)) * x * x + 1;
    c[2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1;
    c[3] = 1.f - c[0] - c[1] - c[2];
  };
  double sx_scale = (double)sw / dw, sy_scale = (double)sh / dh;
  std::vector<int> xofs((size_t)dw * 4), yofs((size_t)dh * 4);
  std::vector<float> ax((size_t)dw * 4), ay((size_t)dh * 4);
  for (int d = 0; d < dw; ++d) {
    float f = (float)((d + 0.5) * sx_scale - 0.5);
    int s = (int)std::floor(f);
    f -= s;
    coeffs(f, &ax[d * 4]);
    for (int k = 0; k < 4; ++k) xofs[d * 4 + k] = std::min(std::max(s - 1 + k, 0), sw - 1);
  }
  for (int d = 0; d < dh; ++d) {
    float f = (float)((d + 0.5) * sy_scale - 0.5);
    int s = (int)std::floor(f);
    f -= s;
    coeffs(f, &ay[d * 4]);
    for (int k = 0; k < 4; ++k) yofs[d * 4 + k] = std::min(std::max(s - 1 + k, 0), sh - 1);
  }
  std::vector<float> rows((size_t)sh * dw * cn);
  for (int y = 0; y < sh; ++y)
    for (int d = 0; d < dw; ++d)
      for (int k = 0; k < cn; ++k) {
        const float* row = src + (size_t)y * sw * cn;
        const int* o = &xofs[d * 4];
        const float* a = &ax[d * 4];
        rows[((size_t)y * dw + d) * cn + k] =
            row[o[0] * cn + k] * a[0] + row[o[1] * cn + k] * a[1] + row[o[2] * cn + k] * a[2] + row[o[3] * cn + k] * a[3];
      }
  size_t rw = (size_t)dw * cn;
  for (int d = 0; d < dh; ++d) {
    const int* o = &yofs[d * 4];
    const float* b = &ay[d * 4];
    const float *s0 = &rows[o[0] * rw], *s1 = &rows[o[1] * rw], *s2 = &rows[o[2] * rw], *s3 = &rows[o[3] * rw];
    float* out = dst + (size_t)d * rw;
    for (size_t i = 0; i < rw; ++i) out[i] = b[0] * s0[i] + b[1] * s1[i] + b[2] * s2[i] + b[3] * s3[i];
  }
}

// cv2.getRotationMatrix2D((cx, cy), angle, scale) into M (2x3 row-major).
void frt_rotation_matrix(double cx, double cy, double angle, double scale, double* M) {
  float fcx = (float)cx, fcy = (float)cy;  // OpenCV's centre is a Point2f
  angle *= M_PI / 180;
  double alpha = std::cos(angle) * scale;
  double beta = std::sin(angle) * scale;
  M[0] = alpha;
  M[1] = beta;
  M[2] = (1 - alpha) * fcx - beta * fcy;
  M[3] = -beta;
  M[4] = alpha;
  M[5] = beta * fcx + (1 - alpha) * fcy;
}

// cv2.warpAffine(src, M, (dw, dh), flags=INTER_LINEAR) with the constant 0
// border on float32 (f64 = 0) or float64 pixels; M maps source to
// destination.
void frt_warp_affine(const void* src, int sh, int sw, int cn, int f64, const double* Min, void* dst, int dh, int dw) {
  double M[6];
  std::memcpy(M, Min, sizeof(M));
  double D = M[0] * M[4] - M[1] * M[3];
  D = D != 0 ? 1. / D : 0;
  double A11 = M[4] * D, A22 = M[0] * D;
  M[0] = A11;
  M[1] *= -D;
  M[3] *= -D;
  M[4] = A22;
  double b1 = -M[0] * M[2] - M[1] * M[5];
  double b2 = -M[3] * M[2] - M[4] * M[5];
  M[2] = b1;
  M[5] = b2;
  if (f64) {
    warp_rows_f64((const double*)src, sh, sw, cn, M, (double*)dst, dh, dw);
    return;
  }
  float m[6];
  for (int i = 0; i < 6; ++i) m[i] = (float)M[i];
  static const bool hw = __builtin_cpu_supports("fma");
  const float* s32 = (const float*)src;
  float* d32 = (float*)dst;
  if (cn == 3)
    warp_rows<3>(hw, s32, sh, sw, cn, m, d32, dh, dw);
  else if (cn == 1)
    warp_rows<1>(hw, s32, sh, sw, cn, m, d32, dh, dw);
  else
    warp_rows<0>(hw, s32, sh, sw, cn, m, d32, dh, dw);
}

// cv2.estimateAffinePartial2D(from, to) (RANSAC, 3 px, 0.99, 2000
// iterations): the similarity M (2x3) fitted by least squares to the
// inliers of RANSAC's best two-point model; mask gets the inliers. Returns
// the inlier count, 0 when there is no model.
int frt_estimate_affine_partial(const float* from, const float* to, int n, double* M, unsigned char* mask) {
  if (n < 2) return 0;
  const float thr2 = (float)(3.0 * 3.0);
  std::vector<unsigned char> cur(n), best(n, 0);
  double model[6], best_model[6] = {0, 0, 0, 0, 0, 0};
  int max_good = 0;
  if (n == 2) {
    similarity_from_two(from, to, best_model);
    std::fill(best.begin(), best.end(), 1);
    max_good = 2;
  } else {
    CvRng rng(~(uint64_t)0);
    int niters = 2000;
    for (int iter = 0; iter < niters; iter++) {
      int idx[2];
      float ms1[4], ms2[4];
      for (int i = 0; i < 2; ++i) {
        int j = rng.uniform(0, n);
        while (i == 1 && j == idx[0]) j = rng.uniform(0, n);
        idx[i] = j;
        ms1[2 * i] = from[2 * j];
        ms1[2 * i + 1] = from[2 * j + 1];
        ms2[2 * i] = to[2 * j];
        ms2[2 * i + 1] = to[2 * j + 1];
      }
      similarity_from_two(ms1, ms2, model);
      int good = count_inliers(from, to, n, model, thr2, cur.data());
      if (good > std::max(max_good, 1)) {
        best.swap(cur);
        std::memcpy(best_model, model, sizeof(model));
        max_good = good;
        niters = ransac_update_iters(0.99, (double)(n - good) / n, 2, niters);
      }
    }
  }
  if (max_good <= 0) return 0;
  // Least-squares similarity on the inliers: x' = a x - b y + tx,
  // y' = b x + a y + ty, solved about the inliers' means.
  double mx = 0, my = 0, mX = 0, mY = 0;
  int k = 0;
  for (int i = 0; i < n; ++i)
    if (best[i]) {
      mx += from[2 * i];
      my += from[2 * i + 1];
      mX += to[2 * i];
      mY += to[2 * i + 1];
      ++k;
    }
  mx /= k, my /= k, mX /= k, mY /= k;
  double sxx = 0, sa = 0, sb = 0;
  for (int i = 0; i < n; ++i)
    if (best[i]) {
      double x = from[2 * i] - mx, y = from[2 * i + 1] - my;
      double X = to[2 * i] - mX, Y = to[2 * i + 1] - mY;
      sxx += x * x + y * y;
      sa += x * X + y * Y;
      sb += x * Y - y * X;
    }
  double a = sa / sxx, b = sb / sxx;
  M[0] = a;
  M[1] = -b;
  M[2] = mX - a * mx + b * my;
  M[3] = b;
  M[4] = a;
  M[5] = mY - b * mx - a * my;
  if (mask) std::memcpy(mask, best.data(), n);
  return max_good;
}

}  // extern "C"
