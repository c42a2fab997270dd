"""The port's image decoder against the JAX package's ``load_image`` (PIL).

JPEG and PNG files are written in ``tmp_path`` by PIL and by a small PNG
encoder here (every colour type and bit depth, all five filters, Adam7),
then read by the JAX ``load_image`` (PIL) and by the port's (its own
decoder: PNG on zlib, JPEG through libjpeg on this machine). Bounds: bit for
bit for every format, except 16-bit gray PNG, where PIL clips the 16-bit
value to 255 and the port keeps the high byte, as libpng's
``png_set_strip_16`` in ``native/decode.cpp`` (both pinned exactly). Other
formats raise ``OSError`` naming the format.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from facerecognition_tpu.data import native_decode as jnd
from facerecognition_tpu.utils import imageio as jimageio
from facerecognition_tpu_torch.data import native_decode as pnd
from facerecognition_tpu_torch.utils import imageio as pimageio

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter(kind, row, prev, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i] if prev is not None else 0
        c = prev[i - bpp] if prev is not None and i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _pack(samples, depth):
    """One row of samples (W, C) as PNG bytes at ``depth`` bits."""
    flat = samples.reshape(-1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    per = 8 // depth
    pad = (-len(flat)) % per
    flat = np.concatenate([flat, np.zeros(pad, np.int64)]).reshape(-1, per)
    shifts = 8 - depth * (np.arange(per) + 1)
    return (flat << shifts).sum(1).astype(np.uint8).tobytes()


def encode_png(samples, color, depth, palette=None, trns=None, interlace=False):
    """A PNG of (H, W, C) integer ``samples``; each row takes filter
    ``row % 5`` so all five are exercised."""
    h, w = samples.shape[:2]
    bpp = max(1, CHANNELS[color] * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = bytearray()
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = None
        for r, row in enumerate(sub):
            packed = _pack(row, depth)
            raw += bytes([r % 5]) + _filter(r % 5, packed, prev, bpp)
            prev = packed

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                               int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")


def _png_cases(rng):
    h, w = 13, 11  # odd sizes: partial bytes at low depths, empty Adam7 columns
    cases = {}
    for interlace in (False, True):
        tag = "_adam7" if interlace else ""
        for depth in (1, 2, 4, 8):
            g = rng.integers(0, 1 << depth, (h, w, 1))
            cases[f"gray{depth}{tag}"] = encode_png(g, 0, depth, interlace=interlace)
        cases[f"rgb8{tag}"] = encode_png(rng.integers(0, 256, (h, w, 3)), 2, 8, interlace=interlace)
        cases[f"rgba8{tag}"] = encode_png(rng.integers(0, 256, (h, w, 4)), 6, 8, interlace=interlace)
        cases[f"gray_alpha8{tag}"] = encode_png(rng.integers(0, 256, (h, w, 2)), 4, 8,
                                                interlace=interlace)
        for depth in (1, 2, 4, 8):
            n = 1 << depth
            pal = rng.integers(0, 256, (n, 3))
            idx = rng.integers(0, n, (h, w, 1))
            cases[f"palette{depth}{tag}"] = encode_png(idx, 3, depth, pal, interlace=interlace)
            cases[f"palette{depth}_trns{tag}"] = encode_png(
                idx, 3, depth, pal, trns=bytes(rng.integers(0, 256, n // 2 + 1).astype(np.uint8)),
                interlace=interlace)
        cases[f"rgb16{tag}"] = encode_png(rng.integers(0, 65536, (h, w, 3)), 2, 16, interlace=interlace)
        cases[f"rgba16{tag}"] = encode_png(rng.integers(0, 65536, (h, w, 4)), 6, 16,
                                           interlace=interlace)
        cases[f"gray_alpha16{tag}"] = encode_png(rng.integers(0, 65536, (h, w, 2)), 4, 16,
                                                 interlace=interlace)
        cases[f"gray8_trns{tag}"] = encode_png(rng.integers(0, 256, (h, w, 1)), 0, 8,
                                               trns=b"\x00\x07", interlace=interlace)
    return cases


def _pil_bytes(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _smooth(rng, h, w, channels=3):
    coarse = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, channels)).astype(np.float32)
    up = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w]
    return np.clip(up + rng.normal(0, 6, up.shape), 0, 255).astype(np.uint8)


def _jpeg_cases(rng):
    rgb = Image.fromarray(_smooth(rng, 61, 77))
    gray = Image.fromarray(_smooth(rng, 40, 33, 1)[..., 0])
    cases = {
        "baseline_420": _pil_bytes(rgb, "JPEG", quality=90),
        "baseline_444": _pil_bytes(rgb, "JPEG", quality=95, subsampling=0),
        "baseline_422": _pil_bytes(rgb, "JPEG", quality=75, subsampling=1),
        "progressive": _pil_bytes(rgb, "JPEG", quality=85, progressive=True),
        "progressive_444": _pil_bytes(rgb, "JPEG", quality=85, progressive=True, subsampling=0),
        "optimized": _pil_bytes(rgb, "JPEG", quality=60, optimize=True),
        "gray": _pil_bytes(gray, "JPEG", quality=90),
        "gray_progressive": _pil_bytes(gray, "JPEG", quality=90, progressive=True),
    }
    import cv2

    ok, enc = cv2.imencode(".jpg", np.asarray(rgb)[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert ok
    cases["cv2_progressive"] = enc.tobytes()
    for name in ("411", "440", "422"):  # 4:1:1 replicates, 4:4:0 is the 1x2 triangle filter
        factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name}")
        ok, enc = cv2.imencode(".jpg", np.asarray(rgb)[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
        assert ok
        cases[f"cv2_{name}"] = enc.tobytes()
    tiny = Image.fromarray(_smooth(rng, 9, 3))  # chroma planes 2 samples wide: replicated
    cases["narrow"] = _pil_bytes(tiny, "JPEG", quality=90)
    return cases


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(40)
    root = tmp_path_factory.mktemp("imagefiles")
    out = {}
    for kind, cases in (("png", _png_cases(rng)), ("jpg", _jpeg_cases(rng))):
        for name, data in cases.items():
            path = root / f"{name}.{kind}"
            path.write_bytes(data)
            out[f"{kind}_{name}"] = str(path)
    return out


def test_decoder_builds_with_libjpeg_here():
    assert pnd.available()
    assert pnd.jpeg_backend() == "libjpeg"


def test_every_format_equals_pil(files):
    for name, path in files.items():
        got = pimageio.load_image(path)
        want = jimageio.load_image(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        if name.startswith("png_gray16"):
            continue
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_bytes_equal_paths(files):
    for name, path in files.items():
        with open(path, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(pimageio.load_image(data), pimageio.load_image(path),
                                      err_msg=name)


def test_native_decode_mem_agrees_with_jax_native(files):
    """The JAX package's libpng/libjpeg build reads the same pixels."""
    if not jnd.available():
        pytest.skip("the JAX package's native decoder does not build here")
    for name, path in files.items():
        with open(path, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(pnd.decode_mem(data), jnd.decode_mem(data), err_msg=name)


def test_gray16_keeps_the_high_byte(tmp_path, rng):
    """16-bit gray: the port keeps the high byte (libpng's strip_16, as
    native/decode.cpp); PIL converts I;16 to RGB by clipping at 255."""
    g = rng.integers(0, 65536, (9, 10, 1))
    g[0, :3, 0] = (0, 255, 65535)
    for interlace in (False, True):
        path = tmp_path / f"g16_{interlace}.png"
        path.write_bytes(encode_png(g, 0, 16, interlace=interlace))
        got = pimageio.load_image(str(path))
        np.testing.assert_array_equal(got, np.repeat((g >> 8).astype(np.uint8), 3, -1))
        pil = jimageio.load_image(str(path))
        np.testing.assert_array_equal(pil, np.repeat(np.minimum(g, 255).astype(np.uint8), 3, -1))


def test_decode_batch_equals_jax_native(files):
    paths = [p for n, p in sorted(files.items()) if not n.startswith("png_gray16")]
    paths.insert(3, "missing.png")
    for size in (16, 112):
        got, ok = pnd.decode_batch(paths, size, n_threads=3)
        assert ok.tolist() == [p != "missing.png" for p in paths]
        assert not got[3].any()
        if jnd.available():
            want, want_ok = jnd.decode_batch(paths, size, n_threads=2)
            np.testing.assert_array_equal(ok, want_ok)
            np.testing.assert_array_equal(got, want)


def test_other_formats_raise_naming_the_format(tmp_path, rng):
    img = Image.fromarray(rng.integers(0, 256, (12, 12, 3)).astype(np.uint8))
    for fmt, name in (("BMP", "BMP"), ("WEBP", "WebP"), ("GIF", "GIF"), ("TIFF", "TIFF")):
        path = tmp_path / f"x.{fmt.lower()}"
        img.save(path, format=fmt)
        with pytest.raises(OSError, match=name):
            pimageio.load_image(str(path))
        assert jimageio.load_image(str(path)).shape == (12, 12, 3)  # PIL reads it
    cmyk = tmp_path / "cmyk.jpg"
    img.convert("CMYK").save(cmyk, format="JPEG")
    with pytest.raises(OSError, match="CMYK"):
        pimageio.load_image(str(cmyk))
    with pytest.raises(OSError, match="unknown"):
        pimageio.load_image(b"not an image at all")


def test_broken_files_raise(tmp_path, files):
    with open(files["png_rgb8"], "rb") as f:
        png = f.read()
    with open(files["jpg_baseline_420"], "rb") as f:
        jpg = f.read()
    bad_crc = bytearray(png)
    bad_crc[20] ^= 0xFF  # inside IHDR
    for data, match in ((bytes(bad_crc), "CRC"), (png[:60], "truncated|no image data"),
                        (jpg[:200], "JPEG")):
        with pytest.raises(OSError, match=match):
            pimageio.load_image(data)
        path = tmp_path / "bad.img"
        path.write_bytes(data)
        with pytest.raises(OSError):
            jimageio.load_image(str(path))
            jimageio.load_image(str(path)).sum()


@pytest.fixture
def decoder_without_jpeg(monkeypatch):
    """The decoder as a machine with neither libjpeg nor nvJPEG builds it."""
    from facerecognition_tpu_torch import _build

    def fresh():
        _build._loaded.pop("host:decode", None)
        pnd._lib.cache_clear()

    fresh()
    monkeypatch.setattr(_build, "jpeg_config", lambda cxx: ("none", ()))
    yield
    monkeypatch.undo()
    fresh()


def test_machine_failures_raise_runtime_error_not_os_error(decoder_without_jpeg, files):
    """A JPEG that this build cannot decode for want of a backend is the
    machine's failure: ``RuntimeError``, from ``decode_mem`` and from
    ``decode_batch``, never the ``OSError`` of an undecodable file. Data
    faults stay ``OSError`` and PNG still decodes."""
    assert pnd.jpeg_backend() == "none"
    with open(files["jpg_baseline_420"], "rb") as f:
        jpg = f.read()
    with pytest.raises(RuntimeError, match="no JPEG decoder was built"):
        pnd.decode_mem(jpg)
    with pytest.raises(RuntimeError, match="no JPEG decoder was built"):
        pimageio.load_image(files["jpg_baseline_420"])
    with pytest.raises(OSError, match="no frame header"):
        pnd.decode_mem(jpg[:20])
    with pytest.raises(OSError, match="unknown"):
        pnd.decode_mem(b"not an image at all")
    assert pnd.decode_mem(open(files["png_rgb8"], "rb").read()).ndim == 3
    with pytest.raises(RuntimeError, match="decoder itself failed"):
        pnd.decode_batch([files["png_rgb8"], files["jpg_baseline_420"], "missing.png"], 16)
    _, ok = pnd.decode_batch([files["png_rgb8"], "missing.png"], 16)
    assert ok.tolist() == [True, False]


def test_missing_file_raises_file_not_found():
    with pytest.raises(FileNotFoundError):
        pimageio.load_image("missing.jpg")
    with pytest.raises(FileNotFoundError):
        jimageio.load_image("missing.jpg")
    with pytest.raises(TypeError):
        pimageio.load_image(3)


def test_port_png_writer_reads_back_in_pil(tmp_path, rng):
    for shape in ((7, 9), (7, 9, 3), (7, 9, 1)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        path = pimageio.save_png(tmp_path / "w.png", img)
        want = np.asarray(Image.open(path).convert("RGB"))
        expect = np.repeat(img.reshape(7, 9, -1), 3 // img.reshape(7, 9, -1).shape[2], -1)
        np.testing.assert_array_equal(want, expect)
        np.testing.assert_array_equal(pimageio.load_image(path), want)
    with pytest.raises(ValueError):
        pimageio.encode_png(np.zeros((4, 4, 4), np.uint8))
