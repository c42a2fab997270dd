"""ctypes bindings of the renderer's rasteriser (``csrc/raster.cpp``).

The port's counterpart of each OpenCV call that the JAX package's
procedural renderer (``training/synthetic_faces.py``, ``ood_faces.py``)
makes, with cv2's arguments: the drawing functions draw in place into
C-contiguous float32 or float64 (H, W) or (H, W, 3) arrays, as cv2 draws
into the renderer's arrays of either type; ``gaussian_blur`` and
``warp_affine`` return a new array of their input's type (float32 or
float64), ``resize_cubic`` a float32 one. ``warp_affine_u8_reflect``,
``resize_area_u8`` and ``gaussian_blur_u8`` take and return uint8 images:
the detector robustness script's transforms
(``scripts/detector_robustness.py``). The library is built
with the host C++ compiler at first use into ``_build/``
(``_build.build_host``); a failed build raises. ctypes releases the GIL for
each call, so producer threads render in parallel; ``DrawList`` records a
face patch's strokes and draws them in one call. ``jpeg_roundtrip`` is
``cv2.imencode``/``imdecode`` through the port's own JPEG encoder and
decoder. How each primitive compares with cv2 is in ROADMAP.md ("Known
differences of the renderer").
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np

from facerecognition_tpu_torch import _build

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_INT = ctypes.c_int
_DBL = ctypes.c_double


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The rasteriser library, built at first use, with its signatures."""
    lib = _build.build_host("raster").lib
    lib.frt_draw_list.argtypes = [_INT, ctypes.POINTER(ctypes.c_void_p), _I32P, _INT, _I32P, _F64P]
    lib.frt_draw_list.restype = _INT
    lib.frt_ellipse2poly.argtypes = [_DBL, _DBL, _DBL, _DBL, _INT, _INT, _INT, _INT, _F64P, _INT]
    lib.frt_ellipse2poly.restype = _INT
    lib.frt_gaussian_kernel.argtypes = [_DBL, _F64P, _INT]
    lib.frt_gaussian_kernel.restype = _INT
    lib.frt_gaussian_blur.argtypes = [ctypes.c_void_p, ctypes.c_void_p, _INT, _INT, _INT, _INT, _DBL]
    lib.frt_resize_cubic.argtypes = [_F32P, _INT, _INT, _INT, _F32P, _INT, _INT]
    lib.frt_rotation_matrix.argtypes = [_DBL, _DBL, _DBL, _DBL, _F64P]
    lib.frt_warp_affine.argtypes = [ctypes.c_void_p, _INT, _INT, _INT, _INT, _F64P, ctypes.c_void_p,
                                    _INT, _INT]
    lib.frt_estimate_affine_partial.argtypes = [_F32P, _F32P, _INT, _F64P, _U8P]
    lib.frt_estimate_affine_partial.restype = _INT
    lib.frt_warp_affine_u8_reflect.argtypes = [_U8P, _INT, _INT, _INT, _F64P, _U8P, _INT, _INT]
    lib.frt_resize_area_u8.argtypes = [_U8P, _INT, _INT, _INT, _U8P, _INT, _INT]
    lib.frt_gaussian_blur_u8.argtypes = [_U8P, _U8P, _INT, _INT, _INT, _DBL]
    for f in ("frt_gaussian_blur", "frt_resize_cubic", "frt_rotation_matrix", "frt_warp_affine",
              "frt_warp_affine_u8_reflect", "frt_resize_area_u8", "frt_gaussian_blur_u8"):
        getattr(lib, f).restype = None
    return lib


def _canvas(img: np.ndarray) -> tuple:
    """(address, h, w, channels, float64) of an image drawn in place; raises
    unless it is a C-contiguous float32 or float64 (H, W) or (H, W, 1|3|4)
    array."""
    if type(img) is not np.ndarray or img.dtype.char not in "fd":
        raise TypeError("raster draws into float32 or float64 arrays")
    if not img.flags.c_contiguous:
        raise TypeError("raster draws into C-contiguous arrays")
    shape = img.shape
    if len(shape) == 2:
        cn = 1
    elif len(shape) == 3 and shape[2] in (1, 3, 4):
        cn = shape[2]
    else:
        raise ValueError(f"raster draws into (H, W) or (H, W, 1|3|4) images, got {shape}")
    return img.ctypes.data, shape[0], shape[1], cn, int(img.dtype.char == "d")


def _color(color) -> tuple:
    """A colour as cv2's Scalar: up to four components, the rest 0."""
    if isinstance(color, (int, float, np.number)):
        return float(color), 0.0, 0.0, 0.0
    vals = [float(c) for c in color][:4]
    return tuple(vals + [0.0] * (4 - len(vals)))


def _ints(p: Sequence) -> tuple[int, int]:
    return int(p[0]), int(p[1])


class DrawList:
    """Drawing calls recorded in order and run by one native call.

    Each method takes cv2's arguments (LINE_8, shift 0; ``thickness`` < 0
    fills) after ``target``, the index of the image in ``run``'s arguments;
    ``run`` draws every recorded call, in order, and empties the list. One
    call per face patch instead of one per stroke keeps the GIL-held part
    of rendering small."""

    _KINDS = {"ellipse": 0, "line": 1, "fill_poly": 2, "rectangle": 3, "circle": 4}

    def __init__(self):
        self._ints: list = []
        self._reals: list = []

    def _add(self, kind: str, target: int, ints: tuple, color, angles=(0.0, 0.0, 0.0)) -> None:
        row = [self._KINDS[kind], int(target), *ints]
        self._ints.append(row + [0] * (12 - len(row)))
        self._reals.append([*angles, *_color(color), 0.0])

    def ellipse(self, target: int, center, axes, angle, start_angle, end_angle, color, thickness: int = 1):
        """``cv2.ellipse``: angles are rounded to whole degrees, as there."""
        ax, ay = _ints(axes)
        if ax < 0 or ay < 0:
            raise ValueError(f"ellipse axes must be >= 0, got {axes}")
        self._add("ellipse", target, (*_ints(center), ax, ay, int(thickness)), color,
                  (float(angle), float(start_angle), float(end_angle)))

    def line(self, target: int, pt1, pt2, color, thickness: int = 1):
        """``cv2.line``."""
        self._add("line", target, (*_ints(pt1), *_ints(pt2), int(thickness)), color)

    def fill_poly(self, target: int, pts, color):
        """``cv2.fillPoly(img, [pts], color)`` of one polygon of 1-4 points."""
        p = np.asarray(pts).reshape(-1, 2)
        if not 1 <= len(p) <= 4:
            raise ValueError(f"fill_poly takes 1 to 4 points, got {len(p)}")
        self._add("fill_poly", target, (len(p), *(int(v) for v in p.ravel())), color)

    def rectangle(self, target: int, pt1, pt2, color, thickness: int = 1):
        """``cv2.rectangle``."""
        self._add("rectangle", target, (*_ints(pt1), *_ints(pt2), int(thickness)), color)

    def circle(self, target: int, center, radius: int, color, thickness: int = 1):
        """``cv2.circle``."""
        self._add("circle", target, (*_ints(center), int(radius), int(thickness)), color)

    def run(self, *images: np.ndarray) -> None:
        if not self._ints:
            return
        canvases = [_canvas(img) for img in images]
        targets = max(row[1] for row in self._ints)
        if targets >= len(images):
            raise ValueError(f"a call draws into image {targets}; {len(images)} given")
        data = (ctypes.c_void_p * len(canvases))(*(c[0] for c in canvases))
        meta = np.ascontiguousarray([c[1:] for c in canvases], np.int32)
        ints = np.ascontiguousarray(self._ints, np.int32)
        reals = np.ascontiguousarray(self._reals, np.float64)
        self._ints, self._reals = [], []
        rc = _lib().frt_draw_list(len(canvases), data, meta.ctypes.data_as(_I32P), len(ints),
                                  ints.ctypes.data_as(_I32P), reals.ctypes.data_as(_F64P))
        if rc != 0:
            raise ValueError("frt_draw_list refused the calls")


def _draw_one(method: str, img, *args) -> None:
    draw = DrawList()
    getattr(draw, method)(0, *args)
    draw.run(img)


def ellipse(img, center, axes, angle, start_angle, end_angle, color, thickness: int = 1) -> None:
    """``cv2.ellipse`` (LINE_8, shift 0): ``thickness`` < 0 fills."""
    _draw_one("ellipse", img, center, axes, angle, start_angle, end_angle, color, thickness)


def ellipse2poly(center, axes, angle: int, start: int, end: int, delta: int) -> np.ndarray:
    """``cv2.ellipse2Poly``'s points before rounding: (N, 2) float64."""
    cap = 2 * (abs(int(end) - int(start)) // int(delta) + 4) + 8
    buf = (ctypes.c_double * (2 * cap))()
    n = _lib().frt_ellipse2poly(float(center[0]), float(center[1]), float(axes[0]), float(axes[1]),
                                int(angle), int(start), int(end), int(delta), buf, cap)
    return np.frombuffer(buf, np.float64)[: 2 * min(n, cap)].reshape(-1, 2).copy()


def fill_poly(img, pts, color) -> None:
    """``cv2.fillPoly(img, [pts], color)`` of one polygon of 1-4 points."""
    _draw_one("fill_poly", img, pts, color)


def line(img, pt1, pt2, color, thickness: int = 1) -> None:
    """``cv2.line`` (LINE_8, shift 0)."""
    _draw_one("line", img, pt1, pt2, color, thickness)


def rectangle(img, pt1, pt2, color, thickness: int = 1) -> None:
    """``cv2.rectangle`` (LINE_8, shift 0): ``thickness`` < 0 fills."""
    _draw_one("rectangle", img, pt1, pt2, color, thickness)


def circle(img, center, radius: int, color, thickness: int = 1) -> None:
    """``cv2.circle`` (LINE_8, shift 0): ``thickness`` < 0 fills."""
    _draw_one("circle", img, center, radius, color, thickness)


def _image(img: np.ndarray, dtypes=(np.float32, np.float64)) -> tuple[np.ndarray, int]:
    """A C-contiguous copy or view of a float (H, W) or (H, W, C) image and
    its channel count; raises for another type or shape."""
    img = np.asarray(img)
    if img.dtype not in dtypes:
        raise TypeError(f"expected a {' or '.join(np.dtype(d).name for d in dtypes)} image, got {img.dtype}")
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        return img, 1
    if img.ndim == 3:
        return img, img.shape[2]
    raise ValueError(f"expected an (H, W) or (H, W, C) image, got {img.shape}")


def gaussian_kernel(sigma: float) -> np.ndarray:
    """The taps of ``cv2.GaussianBlur(img, (0, 0), sigma)`` for float
    images, in float64 (a float32 image's are these cast to float32)."""
    buf = (ctypes.c_double * 256)()
    n = _lib().frt_gaussian_kernel(float(sigma), buf, 256)
    return np.frombuffer(buf, np.float64)[:n].copy()


def gaussian_blur(img, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a float32 or float64
    image, in its type."""
    src, cn = _image(img)
    if not 0 < sigma < 31:
        raise ValueError(f"gaussian_blur takes 0 < sigma < 31, got {sigma}")
    out = np.empty_like(src)
    _lib().frt_gaussian_blur(src.ctypes.data, out.ctypes.data, src.shape[0], src.shape[1], cn,
                             int(src.dtype == np.float64), float(sigma))
    return out


def resize_cubic(img, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_CUBIC)`` of a float32
    image."""
    src, cn = _image(img, (np.float32,))
    w, h = int(dsize[0]), int(dsize[1])
    out = np.empty((h, w) + src.shape[2:], np.float32)
    _lib().frt_resize_cubic(src.ctypes.data_as(_F32P), src.shape[0], src.shape[1], cn,
                            out.ctypes.data_as(_F32P), h, w)
    return out


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64."""
    m = np.empty((2, 3), np.float64)
    _lib().frt_rotation_matrix(float(center[0]), float(center[1]), float(angle), float(scale),
                               m.ctypes.data_as(_F64P))
    return m


def warp_affine(img, m, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), flags=INTER_LINEAR)`` with the
    constant 0 border, of a float32 or float64 image, in its type."""
    src, cn = _image(img)
    mat = np.ascontiguousarray(np.asarray(m, np.float64).reshape(2, 3))
    w, h = int(dsize[0]), int(dsize[1])
    out = np.empty((h, w) + src.shape[2:], src.dtype)
    _lib().frt_warp_affine(src.ctypes.data, src.shape[0], src.shape[1], cn, int(src.dtype == np.float64),
                           mat.ctypes.data_as(_F64P), out.ctypes.data, h, w)
    return out


def warp_affine_u8_reflect(img, m, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), flags=INTER_LINEAR,
    borderMode=BORDER_REFLECT)`` of a uint8 image."""
    src, cn = _image(img, (np.uint8,))
    mat = np.ascontiguousarray(np.asarray(m, np.float64).reshape(2, 3))
    w, h = int(dsize[0]), int(dsize[1])
    out = np.empty((h, w) + src.shape[2:], np.uint8)
    _lib().frt_warp_affine_u8_reflect(src.ctypes.data_as(_U8P), src.shape[0], src.shape[1], cn,
                                      mat.ctypes.data_as(_F64P), out.ctypes.data_as(_U8P), h, w)
    return out


def resize_area_u8(img, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_AREA)`` of a uint8
    image."""
    src, cn = _image(img, (np.uint8,))
    w, h = int(dsize[0]), int(dsize[1])
    if w < 1 or h < 1:
        raise ValueError(f"resize_area_u8: empty output size {dsize}")
    out = np.empty((h, w) + src.shape[2:], np.uint8)
    _lib().frt_resize_area_u8(src.ctypes.data_as(_U8P), src.shape[0], src.shape[1], cn,
                              out.ctypes.data_as(_U8P), h, w)
    return out


def gaussian_blur_u8(img, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a uint8 image (OpenCV's
    fixed-point path)."""
    src, cn = _image(img, (np.uint8,))
    if not 0 < sigma < 40:
        raise ValueError(f"gaussian_blur_u8 takes 0 < sigma < 40, got {sigma}")
    out = np.empty_like(src)
    _lib().frt_gaussian_blur_u8(src.ctypes.data_as(_U8P), out.ctypes.data_as(_U8P), src.shape[0],
                                src.shape[1], cn, float(sigma))
    return out


def estimate_affine_partial(src, dst) -> tuple[np.ndarray, np.ndarray]:
    """``cv2.estimateAffinePartial2D(src, dst)``: the (2, 3) float64
    similarity and the (N, 1) uint8 inlier mask; raises when there is none."""
    a = np.ascontiguousarray(np.asarray(src, np.float32).reshape(-1, 2))
    b = np.ascontiguousarray(np.asarray(dst, np.float32).reshape(-1, 2))
    if len(a) != len(b):
        raise ValueError(f"estimate_affine_partial: {len(a)} source and {len(b)} target points")
    m = np.empty((2, 3), np.float64)
    mask = np.zeros((len(a), 1), np.uint8)
    good = _lib().frt_estimate_affine_partial(a.ctypes.data_as(_F32P), b.ctypes.data_as(_F32P), len(a),
                                              m.ctypes.data_as(_F64P), mask.ctypes.data_as(_U8P))
    if good <= 0:
        raise ValueError("estimate_affine_partial: no similarity fits these points")
    return m, mask


def jpeg_roundtrip(rgb_u8: np.ndarray, quality: int) -> np.ndarray:
    """Encode (H, W, 3) RGB uint8 as JPEG at ``quality`` and decode it, as
    float32: the renderer's compression artefacts (cv2.imencode/imdecode in
    the JAX package; here the port's encoder and decoder)."""
    from facerecognition_tpu_torch.data import native_decode
    from facerecognition_tpu_torch.utils.imageio import encode_jpeg

    return native_decode.decode_mem(encode_jpeg(rgb_u8, quality)).astype(np.float32)
