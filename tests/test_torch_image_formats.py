"""The port's image codec against `cv2.imread` on the formats the system's
paths meet beyond baseline JPEG and plain PNG: progressive JPEG, Exif
orientation (JPEG APP1, PNG eXIf), and PNG at every colour type and legal
bit depth, interlaced or not, with or without tRNS. Every file is written
here: with cv2 where it can write it, by hand with zlib and struct
otherwise. Each is held to cv2 bit for bit in the colour, gray and
unchanged read modes. Then `SegmentImage` and `SessionData.from_export_dir`
of both packages over progressive, Exif-turned JPEGs."""

import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from fusion3dseg_tpu.io import rtab as jrtab, synthetic as jsyn
from fusion3dseg_tpu.pipeline import get2dseg as jget
from fusion3dseg_tpu_torch.io import image, rtab as trtab
from fusion3dseg_tpu_torch.pipeline import get2dseg as tget
from torch_seg_pair import segmenter_pair

MODES = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
         "unchanged": cv2.IMREAD_UNCHANGED}


def picture(rng, h, w, channels=3):
    """A smooth gradient with texture and noise: coefficients of every
    size, so that each progressive scan has work."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (y * 5) % 256, (x * y) % 256], axis=-1)[..., :channels]
    img = base + rng.integers(-40, 40, (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def assert_reads_as_cv2(path):
    """image.read of `path` equals cv2.imread in all three modes, cv2's BGR
    taken to the port's RGB."""
    for mode, flag in MODES.items():
        want = cv2.imread(str(path), flag)
        assert want is not None, (path, mode)
        got = image.read(path, gray=mode == "gray", unchanged=mode == "unchanged")
        if want.ndim == 3:
            want = want[..., [2, 1, 0, 3][:want.shape[2]]]
        assert got.shape == want.shape and got.dtype == want.dtype, (mode, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{path.name} {mode}")


# ------------------------------------------------------- progressive JPEG --

SAMPLING = {"gray": None, "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


@pytest.mark.parametrize("hw", [(191, 257), (1, 1), (480, 640)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("restart", [0, 3], ids=["no_restart", "restart3"])
@pytest.mark.parametrize("layout", list(SAMPLING))
def test_progressive_jpeg(tmp_path, layout, restart, hw):
    rng = np.random.default_rng(zlib.crc32(repr((layout, restart, hw)).encode()))
    img = picture(rng, *hw, channels=1 if layout == "gray" else 3)
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 90,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if SAMPLING[layout] is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[layout]]
    path = tmp_path / "p.jpg"
    assert cv2.imwrite(str(path), img, params)
    data = path.read_bytes()
    assert b"\xff\xc2" in data and (b"\xff\xdd" in data) == bool(restart)
    assert_reads_as_cv2(path)


def test_refused_jpeg_layouts_raise(tmp_path):
    """Arithmetic coding (SOF9) and lossless (SOF3) stay refused, with a
    reason: no camera of the system's inputs writes them."""
    data = bytearray(cv2.imencode(".jpg", picture(np.random.default_rng(0), 16, 16))[1])
    sof = data.index(b"\xff\xc0")
    for marker, reason in ((0xC9, "arithmetic"), (0xC3, "lossless")):
        data[sof + 1] = marker
        with pytest.raises(image.ImageError, match=reason):
            image.decode(bytes(data))


# ------------------------------------------------------------------- Exif --

def tiff_orientation(orientation, little):
    """A TIFF structure whose IFD0 holds ResolutionUnit and Orientation."""
    e = "<" if little else ">"
    entries = [(0x0128, 3, 1, 2), (0x0112, 3, 1, orientation)]
    body = struct.pack(e + "H", len(entries)) + b"".join(
        struct.pack(e + "HHIHH", tag, kind, n, v, 0) for tag, kind, n, v in entries)
    return (b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8) + body + b"\0\0\0\0"


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_exif_orientation(tmp_path, fmt, orientation):
    """A portrait-shaped, asymmetric frame tagged with each orientation, in
    both TIFF byte orders (odd orientations little-endian): cv2 turns it
    in colour and gray reads and keeps it in unchanged reads."""
    rng = np.random.default_rng(orientation)
    img = picture(rng, 40, 24)
    tiff = tiff_orientation(orientation, little=orientation % 2 == 1)
    if fmt == "jpeg":  # an APP1 segment spliced in after SOI
        data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, orientation % 2])[1]
        app1 = b"Exif\0\0" + tiff
        data = data.tobytes()
        data = data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]
    else:  # an eXIf chunk before IDAT
        data = png_file(img[..., ::-1], ctype=2, depth=8, exif=tiff, rng=rng)
    path = tmp_path / f"o{orientation}.{'jpg' if fmt == 'jpeg' else 'png'}"
    path.write_bytes(data)
    assert_reads_as_cv2(path)
    turned = cv2.imread(str(path)).shape[:2]
    assert turned == ((24, 40) if orientation >= 5 else (40, 24))


# -------------------------------------------------------------------- PNG --

def _filter_rows(rows, bpp, rng):
    """Each row under a random one of the five filters, its type byte first."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        kind = int(rng.integers(0, 5))
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - a
        elif kind == 2:
            f = row - prev
        elif kind == 3:
            f = row - (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            f = row - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(np.concatenate([[kind], f & 0xFF]).astype(np.uint8))
        prev = row
    return b"".join(r.tobytes() for r in out)


def _pack(samples, depth):
    """[h, w, c] samples -> [h, rowbytes] bytes of one PNG row each."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = -(-flat.shape[1] // per) * per
    padded = np.zeros((h, n), np.uint8)
    padded[:, :flat.shape[1]] = flat
    shifts = np.arange(8 - depth, -1, -depth)
    return (padded.reshape(h, -1, per) << shifts).sum(axis=2).astype(np.uint8)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(body, zlib.crc32(kind)))


def png_file(samples, ctype, depth, rng, interlace=False, palette=None, trns=None, exif=None):
    """A PNG of [h, w(, c)] samples in the stored channel order, written by
    hand: random row filters, Adam7 passes when `interlace`."""
    samples = samples.reshape(samples.shape[0], samples.shape[1], -1)
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack(sub, depth), bpp, rng)
    out = image.PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                        int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    if exif is not None:
        out += _chunk(b"eXIf", exif)
    return out + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")


PNG_CASES = [(ctype, depth, trns) for ctype, depths in
             ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16)))
             for depth in depths for trns in ((False, True) if ctype in (0, 2, 3) else (False,))]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth,trns", PNG_CASES,
                         ids=[f"type{c}_{d}bit{'_trns' if t else ''}" for c, d, t in PNG_CASES])
def test_png_matrix(tmp_path, ctype, depth, trns, interlace):
    """Odd sizes (13 x 11, so every Adam7 pass is ragged), random samples
    that include the transparent key colour for tRNS."""
    rng = np.random.default_rng(ctype * 100 + depth * 2 + trns)
    h, w = 13, 11
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) - 1
    palette = trns_body = None
    if ctype == 3:
        n = min(top + 1, 200)
        samples = rng.integers(0, n, (h, w, 1))
        palette = rng.integers(0, 256, (n, 3))
        palette[n - 1] = (7, 7, 7)  # a gray entry passes through libpng's gray rule
        if trns:
            trns_body = rng.integers(0, 256, max(1, n // 2)).astype(np.uint8).tobytes()
    else:
        samples = rng.integers(0, top + 1, (h, w, channels))
        if ctype in (2, 6):
            samples[0, :4, 1:3] = samples[0, :4, :1]  # some gray pixels
        if trns:
            key = samples[2, 3]
            samples[5, 5] = key  # the key twice
            trns_body = struct.pack(">" + "H" * channels, *key.tolist())
    path = tmp_path / "m.png"
    path.write_bytes(png_file(samples, ctype, depth, rng, interlace, palette, trns_body))
    assert_reads_as_cv2(path)


def test_png_refuses_illegal_depth():
    bad = png_file(np.zeros((2, 2, 3), np.uint8), ctype=2, depth=8,
                   rng=np.random.default_rng(0)).replace(b"\x08\x02\x00", b"\x04\x02\x00", 1)
    with pytest.raises(image.ImageError, match="colour type 2, bit depth 4"):
        image.decode(bad)


# ------------------------------------------------------------ end to end --

def _progressive_turned(img_rgb, orientation):
    """A progressive JPEG of `img_rgb` carrying Exif `orientation`."""
    data = cv2.imencode(".jpg", np.ascontiguousarray(img_rgb[..., ::-1]),
                        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 95])[1]
    app1 = b"Exif\0\0" + tiff_orientation(orientation, little=orientation % 2 == 0)
    return data[:2].tobytes() + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 \
        + data[2:].tobytes()


def test_segment_image_over_progressive_turned_jpegs(tmp_path):
    """Both packages' SegmentImage over one folder of progressive JPEGs
    with orientations 1, 3, 6 and 8 (portrait and landscape frames in one
    batch, so the frames of the other shape are resized to the first's):
    equal masks."""
    (tmp_path / "ckpt").mkdir()
    jseg, tseg = segmenter_pair(tmp_path / "ckpt")
    sess = jsyn.make_session(nframes=4, depth_hw=(48, 36), appearance="textured")
    src = tmp_path / "rgb"
    src.mkdir()
    for i, (frame, orientation) in enumerate(zip(sess.colors, (1, 3, 6, 8))):
        (src / f"{i}.jpg").write_bytes(_progressive_turned(frame, orientation))
    jget.SegmentImage(src, tmp_path / "jax", segmenter=jseg, conf_threshold=0.0)
    tget.SegmentImage(src, tmp_path / "port", segmenter=tseg, conf_threshold=0.0)
    for i in range(4):
        want = cv2.imread(str(tmp_path / "jax" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        got = image.read(tmp_path / "port" / f"{i}.png", unchanged=True)
        assert got.shape == want.shape == ((36, 48) if i >= 2 else (48, 36))
        np.testing.assert_array_equal(got, want)


def test_from_export_dir_over_progressive_turned_jpegs(tmp_path):
    """An export whose RGB frames are progressive JPEGs turned by Exif
    orientations that keep the frame's shape (1-4): both packages read the
    same arrays."""
    sess = jsyn.make_session(nframes=4, depth_hw=(48, 36), appearance="textured")
    d = Path(jsyn.write_session_dir(sess, tmp_path / "export"))
    frames = sorted((d / "rgb").glob("*.jpg"), key=lambda p: int(p.stem))
    for orientation, path in zip((2, 3, 4, 1), frames):
        stored = image.orient(cv2.imread(str(path))[..., ::-1], orientation)  # its own inverse
        path.write_bytes(_progressive_turned(stored, orientation))
    j = jrtab.SessionData.from_export_dir(d)
    t = trtab.SessionData.from_export_dir(d, device="cpu")
    np.testing.assert_array_equal(t.colors.numpy(), j.colors)
    for name in ("depth", "points", "normals"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(j, name))
