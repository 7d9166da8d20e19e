"""Image files: PNG and JPEG, read and written without OpenCV.

The JAX package reads and writes every image through OpenCV (`cv2.imread`,
`cv2.imwrite`, `cv2.resize`); the port runs where no image library is
installed, so it brings its own codec. The PNG chunk structure, zlib
stream, Adam7 interlacing and sub-byte samples are handled here with
Python's `zlib` and numpy; the row filters, the JPEG codec and the Exif
parser are a small host C++ library, `native/image_codec.cpp`, built with
`g++` at first use into the build directory (`io/native.build`). A failed
build raises.

What `read` returns follows `cv2.imread` with the channels in RGB order
(OpenCV's are BGR; callers of the JAX package flip them, callers of this
module must not):

  * `read(path)`: [H, W, 3] uint8 RGB. Gray images are replicated, 16-bit
    samples shifted to 8 bits, alpha dropped.
  * `read(path, gray=True)`: [H, W] uint8. A colour JPEG gives its luma
    plane (what libjpeg returns for a grayscale output); a colour PNG
    converts with libpng's rule, (9797 R + 19234 G + 3737 B) >> 15 and
    gray pixels unchanged at 8 bits, rounded ((... + 16384) >> 15) and
    then shifted to 8 bits at 16, which is what `cv2.imread(f, 0)` does.
  * `read(path, unchanged=True)`: the stored samples: [H, W] for gray
    (uint16 for 16-bit PNG, such as RTAB-Map's depth in millimetres),
    [H, W, 3] or [H, W, 4] for colour. A PNG's alpha comes from its alpha
    channel, or for palette and RGB images from a tRNS chunk, as OpenCV's
    4-channel read gives it; a gray image's tRNS is dropped.

  Both of the first two modes turn the image as its Exif Orientation tag
  says (JPEG APP1, PNG eXIf; OpenCV's ExifTransform: 2 mirrors, 3 turns
  by 180 degrees, 4 flips, 5-8 transpose first), so a phone's portrait
  photograph comes out upright; the unchanged read keeps the stored
  layout, as `IMREAD_UNCHANGED` does.

Read: PNG of every colour type (gray, RGB, palette, gray + alpha, RGBA) at
every legal bit depth (1, 2, 4, 8, 16), interlaced or not; JPEG baseline,
extended sequential and progressive Huffman, 8-bit, gray or YCbCr/RGB, any
integer sampling, restart intervals. JPEG decoding follows libjpeg-turbo's
defaults (ISLOW IDCT, fancy upsampling, its fixed-point YCbCr tables) and so
equals `cv2.imread`. Refused: arithmetic-coded, lossless, hierarchical and
12-bit JPEG, CMYK/YCCK JPEG, and every other format (BMP, TIFF, WebP, ...).
The format is sniffed from the magic bytes, not the file name. `write`
picks the format from the file name: PNG (8-bit gray or RGB, 16-bit gray;
filter 0, zlib level 1, which decodes to the same samples as OpenCV's file)
or baseline JPEG (quality 95 and 4:2:0 by default, standard Huffman tables,
as `cv2.imwrite`).

`resize_nearest` reproduces `cv2.resize(..., INTER_NEAREST)`'s source
index rule, floor(x * (1 / (dst / src))).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from fusion3dseg_tpu_torch.io import native

SOURCE = Path(__file__).resolve().parents[1] / "native" / "image_codec.cpp"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_QUALITY = 95
MAX_PIXELS = 1 << 30  # OpenCV's default limit on a decoded image

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "png_unfilter": [_U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _U8P],
    "jpeg_info": [_U8P, ctypes.c_int64, _I32P],
    "exif_orientation": [_U8P, ctypes.c_int64],
    "jpeg_decode": [_U8P, ctypes.c_int64, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int],
    "jpeg_encode": [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P,
                    ctypes.c_int64],
}
_ERRORS = {
    -1: "truncated data", -2: "not a JPEG stream",
    -4: "arithmetic-coded JPEG (Huffman only)",
    -5: "unsupported JPEG layout (lossless, hierarchical, 12-bit or not 1 or 3 components)",
    -6: "corrupt data", -7: "corrupt Huffman data", -8: "no frame header",
    -9: "output buffer too small",
}


class ImageError(ValueError):
    """A file that is not an image this codec reads, or a corrupt one."""


def _lib() -> ctypes.CDLL:
    return native.load_library(SOURCE, _SIGNATURES, {"jpeg_encode": ctypes.c_int64})


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _check(rc: int, what: str) -> None:
    if rc < 0:
        raise ImageError(f"{what}: {_ERRORS.get(rc, f'error {rc}')}")


# ----------------------------------------------------------------- read --

def read(path, gray: bool = False, unchanged: bool = False) -> np.ndarray:
    """Read a PNG or JPEG file (see the module docstring for the layouts).
    Raises FileNotFoundError for a missing file and ImageError for one
    this codec cannot read."""
    with open(path, "rb") as fp:
        data = fp.read()
    try:
        return decode(data, gray=gray, unchanged=unchanged)
    except ImageError as e:
        raise ImageError(f"{path}: {e}") from None


def decode(data: bytes, gray: bool = False, unchanged: bool = False) -> np.ndarray:
    if data[:8] == PNG_MAGIC:
        return _decode_png(data, gray, unchanged)
    if data[:3] == b"\xff\xd8\xff":
        return _decode_jpeg(data, gray, unchanged)
    raise ImageError("neither a PNG nor a JPEG stream")


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """`img` [H, W, ...] turned as Exif Orientation `orientation` asks, as
    OpenCV's ExifTransform does: 5-8 transpose first, then 2 and 6 mirror
    left-right, 4 and 8 flip top-bottom, 3 and 7 do both; 1 and any other
    value leave the image as it is."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _png_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's png_set_rgb_to_gray(0.299, 0.587): coefficients truncated
    to 15 bits. 8-bit samples: the sum truncated, gray pixels passed
    through. 16-bit samples: the sum rounded, then the high byte (libpng
    converts before it strips the low bytes)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    y = 9797 * r + 19234 * g + 3737 * b
    if rgb.dtype == np.uint16:
        return ((y + 16384) >> 15 >> 8).astype(np.uint8)
    return np.where((r == g) & (r == b), r, y >> 15).astype(np.uint8)


# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# legal bit depths of each PNG colour type, and its samples a pixel
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_samples(raw: bytes, w: int, h: int, depth: int, channels: int,
                 interlace: bool) -> np.ndarray:
    """The zlib-inflated image data -> [h, w, channels] samples (uint16 at
    depth 16, else uint8 holding the sample values, 0 .. 2^depth - 1).
    Interlaced data holds the seven Adam7 passes one after another, each
    with its own filtered rows; a pass with no pixels has no rows."""
    bits = depth * channels
    bpp = max(1, bits // 8)  # the filters' byte distance
    out = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8) if interlace else None
    lib, off = _lib(), 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = (pw * bits + 7) // 8
        n = ph * (rowbytes + 1)
        if off + n > len(raw):
            raise ImageError("truncated PNG data")
        src = np.frombuffer(raw, np.uint8, count=n, offset=off)
        off += n
        rows = np.empty((ph, rowbytes), np.uint8)
        _check(lib.png_unfilter(_u8(src), ph, rowbytes, bpp, _u8(rows)), "PNG")
        if depth == 16:
            px = rows.view(">u2").astype(np.uint16)
        elif depth == 8:
            px = rows
        else:  # 1, 2 or 4 bits a sample, the first in the high bits
            shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
            px = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
            px = px.reshape(ph, -1)[:, :pw * channels]
        if not interlace:
            return px.reshape(h, w, channels)
        out[y0::dy, x0::dx] = px.reshape(ph, pw, channels)
    return out


def _decode_png(data: bytes, gray: bool, unchanged: bool) -> np.ndarray:
    pos, ihdr, idat, palette, trns, exif = 8, None, [], None, None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ImageError("truncated PNG chunk")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"eXIf":
            exif = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or not idat:
        raise ImageError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if w * h > MAX_PIXELS:
        raise ImageError(f"{w}x{h} exceeds {MAX_PIXELS} pixels")
    if depth not in _PNG_DEPTHS.get(ctype, ()) or interlace > 1:
        raise ImageError(f"unsupported PNG (colour type {ctype}, bit depth {depth}, "
                         f"interlace {interlace})")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageError(f"corrupt PNG data ({e})") from None
    img = _png_samples(raw, w, h, depth, _PNG_CHANNELS[ctype], bool(interlace))
    if ctype == 3:  # palette -> RGB, or RGBA where tRNS gives alpha and it is kept
        if palette is None:
            raise ImageError("palette PNG without PLTE")
        table = np.concatenate([palette, np.full((len(palette), 1), 255, np.uint8)], axis=1)
        if trns is not None:
            table[:len(trns[:len(palette)]), 3] = np.frombuffer(trns[:len(palette)], np.uint8)
        idx = img[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ImageError("PNG palette index out of range")
        img = table[idx] if unchanged and trns is not None else table[idx, :3]
    elif ctype == 0:
        img = img[..., 0]
        if depth < 8:  # libpng's expansion to 8 bits: s * 255 / (2^depth - 1)
            img = img * np.uint8(255 // ((1 << depth) - 1))
    elif ctype == 4:  # gray + alpha -> RGBA, as OpenCV's unchanged read gives
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=2), img[..., 1:]], axis=2)
    elif ctype == 2 and trns is not None and len(trns) >= 6 and unchanged:
        key = np.array(struct.unpack(">3H", trns[:6]), np.uint16)
        if depth == 8:
            key &= 0xFF
        alpha = np.where((img == key).all(axis=2), 0, (1 << depth) - 1).astype(img.dtype)
        img = np.concatenate([img, alpha[..., None]], axis=2)
    if unchanged:
        return img
    if img.ndim == 3 and img.shape[2] == 4:
        img = img[..., :3]
    if gray:
        img = img if img.ndim == 2 else _png_gray(img)
    else:
        img = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    return orient(img, _exif_orientation(exif)) if exif else img


def _exif_orientation(tiff: bytes) -> int:
    src = np.frombuffer(tiff, np.uint8)
    return int(_lib().exif_orientation(_u8(src), len(src)))


def _decode_jpeg(data: bytes, gray: bool, unchanged: bool) -> np.ndarray:
    src = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int32)
    lib = _lib()
    _check(lib.jpeg_info(_u8(src), len(src), info.ctypes.data_as(_I32P)), "JPEG")
    w, h, ncomp, orientation = (int(v) for v in info)
    if w * h > MAX_PIXELS:
        raise ImageError(f"{w}x{h} exceeds {MAX_PIXELS} pixels")
    one = (gray and not unchanged) or (unchanged and ncomp == 1)
    out = np.empty((h, w) if one else (h, w, 3), np.uint8)
    _check(lib.jpeg_decode(_u8(src), len(src), int(one), _u8(out), w, h), "JPEG")
    return out if unchanged else orient(out, orientation)


# ---------------------------------------------------------------- write --

def write(path, img: np.ndarray, quality: int = JPEG_QUALITY) -> None:
    """Write `img` as PNG or JPEG by the file name's suffix: [H, W] gray
    (uint8, or uint16 for PNG) or [H, W, 3] RGB uint8."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".png":
        data = encode_png(img)
    elif suffix in (".jpg", ".jpeg"):
        data = encode_jpeg(img, quality)
    else:
        raise ValueError(f"cannot tell the image format of {path.name!r}")
    path.write_bytes(data)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(body, zlib.crc32(kind)))


def encode_png(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG takes uint8 or uint16 samples, got {img.dtype}")
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        ctype = 2
    else:
        raise ValueError(f"PNG takes [H, W] gray or [H, W, 3] RGB uint8, got {img.shape}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    rows = rows.reshape(h, -1)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0
    return (PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 1)) + _chunk(b"IEND", b""))


def encode_jpeg(img: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG takes [H, W] or [H, W, 3] uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    cap = 1024 + 2 * img.size  # q95 on photographs stays far below this
    out = np.empty(cap, np.uint8)
    n = _lib().jpeg_encode(_u8(img), h, w, channels, int(quality), _u8(out), cap)
    _check(n, "JPEG encode")
    return out[:n].tobytes()


# --------------------------------------------------------------- resize --

def nearest_index(src: int, dst: int) -> np.ndarray:
    """INTER_NEAREST's source index of each output index along one axis:
    min(floor(x * (1 / (dst / src))), src - 1)."""
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, out_hw) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)` of an
    [H, W, ...] array."""
    img = np.asarray(img)
    h, w = out_hw
    sh, sw = img.shape[:2]
    if (h, w) == (sh, sw):
        return img
    return img[nearest_index(sh, h)[:, None], nearest_index(sw, w)[None, :]]


_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS: 11-bit fixed-point weights
_DBL_EPSILON = float(np.finfo(np.float64).eps)


def _inv_scale(src: int, dst: int) -> float:
    """OpenCV's source step per output pixel, 1 / (dst / src) in double."""
    return 1.0 / (dst / src)


def _linear_taps(src: int, dst: int, clamp: bool):
    """(index, weight) of INTER_LINEAR along one axis, as OpenCV builds
    them, both [2 * dst]: the first taps of every output index, then the
    second. f = float32((d + 0.5) * scale - 0.5), i = floor(f), f - i in
    float32, each weight rint(float32 * 2048) on its own. `clamp` (OpenCV's
    columns) pins a coordinate outside [0, src - 1] to the edge pixel with
    weight (2048, 0); rows keep their fraction and only their indices are
    clamped."""
    f = ((np.arange(dst) + 0.5) * _inv_scale(src, dst) - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = (f - i.astype(np.float32)).astype(np.float32)
    if clamp:
        edge = (i < 0) | (i >= src - 1)
        f[edge] = 0
        i = np.where(i < 0, 0, np.where(i >= src - 1, src - 1, i))
    one = np.float32(1 << _COEF_BITS)
    w0 = np.rint((np.float32(1) - f) * one).astype(np.int32)
    w1 = np.rint(f * one).astype(np.int32)
    return (np.clip(np.concatenate([i, i + 1]), 0, src - 1),
            np.concatenate([w0, w1]))


_DEVICE_TAPS: dict = {}


def _device_taps(src: int, dst: int, clamp: bool, device: torch.device):
    """`_linear_taps` as tensors on `device`, copied there once a shape."""
    key = (src, dst, clamp, device)
    if key not in _DEVICE_TAPS:
        _DEVICE_TAPS[key] = tuple(torch.as_tensor(t, device=device)
                                  for t in _linear_taps(src, dst, clamp))
    return _DEVICE_TAPS[key]


def resize_linear_uint8(images: torch.Tensor, out_hw) -> torch.Tensor:
    """`cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR)` on uint8
    images [..., H, W, C] (any leading dims, any device), bit for bit.
    Columns first: S = src[i0] * w0 + src[i1] * w1 in int32; then rows:
    (((v0 * (S0 >> 4)) >> 16) + ((v1 * (S1 >> 4)) >> 16) + 2) >> 2. An exact
    2x shrink of both axes takes OpenCV's INTER_AREA route instead."""
    h, w = (int(x) for x in out_hw)
    sh, sw = images.shape[-3:-1]
    if (h, w) == (sh, sw):
        return images
    if _inv_scale(sh, h) == 2.0 and _inv_scale(sw, w) == 2.0:
        return resize_area_uint8(images, (h, w))
    xi, xw = _device_taps(sw, w, True, images.device)
    yi, yw = _device_taps(sh, h, False, images.device)
    # both taps of an axis in one gather, weighted, then the pair summed
    taps = images.index_select(-2, xi).to(torch.int32) * xw[:, None]
    rows = taps.unflatten(-2, (2, w)).sum(dim=-3, dtype=torch.int32) >> 4
    taps = (rows.index_select(-3, yi) * yw[:, None, None]) >> 16
    out = taps.unflatten(-3, (2, h)).sum(dim=-4, dtype=torch.int32).add_(2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


def _area_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of an area (box) downscale along one axis: each
    output cell averages the input cells it covers, edge cells by the
    covered fraction."""
    scale = n_in / n_out
    lo = torch.arange(n_out, dtype=torch.float64, device=device)[:, None] * scale
    cell = torch.arange(n_in, dtype=torch.float64, device=device)[None, :]
    overlap = (torch.minimum(lo + scale, cell + 1) - torch.maximum(lo, cell)).clamp(min=0)
    return (overlap / scale).float()


def resize_area_uint8(images: torch.Tensor, out_hw) -> torch.Tensor:
    """`cv2.resize(im, (w, h), interpolation=cv2.INTER_AREA)` on uint8
    images [..., H, W, C] (any device), shrinking only. OpenCV's paths:
    an integer factor (kx, ky) sums each block in int32 and rounds as
    (S + 2) >> 2 at 2x2, else rint(float32(S) * float32(1 / (kx * ky)));
    other factors average with fractional edge weights in float32 and
    round half to even."""
    h, w = (int(x) for x in out_hw)
    sh, sw = images.shape[-3:-1]
    if (h, w) == (sh, sw):
        return images
    if h > sh or w > sw:
        raise ValueError(f"area resize only shrinks: {(sh, sw)} -> {(h, w)}")
    sy, sx = _inv_scale(sh, h), _inv_scale(sw, w)
    ky, kx = int(round(sy)), int(round(sx))
    if abs(sy - ky) < _DBL_EPSILON and abs(sx - kx) < _DBL_EPSILON:
        lead = images.shape[:-3]
        blocks = images.to(torch.int32).reshape(*lead, h, ky, w, kx, images.shape[-1])
        s = blocks.sum(dim=(-4, -2))
        if (ky, kx) == (2, 2):
            return ((s + 2) >> 2).to(torch.uint8)
        inv = torch.tensor(1.0 / (kx * ky), dtype=torch.float32)
        return torch.round(s.float() * inv.to(images.device)).clamp(0, 255).to(torch.uint8)
    wy = _area_weights(sh, h, images.device)
    wx = _area_weights(sw, w, images.device)
    out = torch.einsum("oh,...hwc,pw->...opc", wy, images.float(), wx)
    return out.round().clamp(0, 255).to(torch.uint8)
