"""The port's image codec (`io/image.py`, `native/image_codec.cpp`) against
OpenCV, which the JAX package reads and writes images with.

PNG reads are exact; JPEG reads equal `cv2.imread` (libjpeg-turbo's ISLOW
IDCT, fancy upsampling and YCbCr tables are reproduced, so no pixel may
differ); the port's JPEG files decode in OpenCV to exactly the port's own
decode; the nearest resize equals `cv2.resize(..., INTER_NEAREST)`."""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from fusion3dseg_tpu_torch.io import image

SIZES = [(191, 257), (1, 1), (480, 640)]
JPEG_LAYOUTS = {
    "gray": None,
    "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "420": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
}


def _photo(rng, h, w, c=3):
    """Smooth content plus noise: blocks with both flat and busy spectra."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k) for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _bgr(img):
    return img[..., ::-1] if img.ndim == 3 else img


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["gray", "rgb", "16bit"])
def test_png_read_write_exact(rng, hw, kind):
    h, w = hw
    if kind == "gray":
        img = rng.integers(0, 256, hw, dtype=np.uint8)
        img[:, : w // 2] = 7  # flat runs: every row filter gets used by libpng
    elif kind == "rgb":
        img = _photo(rng, h, w)
    else:
        img = rng.integers(0, 65536, hw, dtype=np.uint16)
    for level in (1, 9):
        ok, buf = cv2.imencode(".png", _bgr(img), [cv2.IMWRITE_PNG_COMPRESSION, level])
        data = buf.tobytes()
        got = image.decode(data, unchanged=True)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(image.decode(data, gray=True), cv2.imdecode(buf, 0))
        np.testing.assert_array_equal(image.decode(data), _bgr(cv2.imdecode(buf, cv2.IMREAD_COLOR)))
    # the port's file, read by OpenCV
    back = cv2.imdecode(np.frombuffer(image.encode_png(img), np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(_bgr(back), img)
    assert back.dtype == img.dtype


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", list(JPEG_LAYOUTS))
@pytest.mark.parametrize("restart", [0, 3], ids=["no_rst", "rst3"])
def test_jpeg_read_equals_opencv(rng, hw, layout, restart):
    img = _photo(rng, *hw, c=1 if layout == "gray" else 3)
    params = [cv2.IMWRITE_JPEG_QUALITY, 90] + (JPEG_LAYOUTS[layout] or [])
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", _bgr(img), params)
    data = buf.tobytes()
    if restart:
        assert b"\xff\xdd" in data  # the file carries a restart interval
    np.testing.assert_array_equal(image.decode(data), _bgr(cv2.imdecode(buf, cv2.IMREAD_COLOR)))
    np.testing.assert_array_equal(image.decode(data, gray=True), cv2.imdecode(buf, 0))
    if layout == "gray":
        np.testing.assert_array_equal(image.decode(data, unchanged=True), cv2.imdecode(buf, 0))


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [1, 3])
def test_jpeg_write_decodes_equal_in_opencv(rng, hw, channels, tmp_path):
    img = _photo(rng, *hw, c=channels)
    path = tmp_path / "f.jpg"
    image.write(path, img)
    mine = image.read(path, unchanged=True)
    theirs = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(mine, _bgr(theirs))
    assert mine.shape == img.shape
    if hw[0] > 100:  # quality 95 keeps detail
        mse = np.mean((mine.astype(float) - img) ** 2)
        assert 10 * np.log10(255 ** 2 / mse) > 30


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), layout=st.sampled_from(["444", "422", "420"]),
       restart=st.sampled_from([0, 1, 2, 5]), seed=st.integers(0, 2 ** 16))
def test_jpeg_read_sizes(h, w, layout, restart, seed):
    # every MCU-edge case: partial MCUs, a restart at every MCU boundary,
    # the DC predictor reset, fancy upsampling at the last row and column
    img = _photo(np.random.default_rng(seed), h, w)
    params = [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              *JPEG_LAYOUTS[layout]]
    ok, buf = cv2.imencode(".jpg", _bgr(img), params)
    np.testing.assert_array_equal(image.decode(buf.tobytes()),
                                  _bgr(cv2.imdecode(buf, cv2.IMREAD_COLOR)))


@settings(max_examples=60, deadline=None)
@given(sh=st.integers(1, 300), sw=st.integers(1, 300), h=st.integers(1, 300),
       w=st.integers(1, 300))
def test_resize_nearest_equals_opencv(sh, sw, h, w):
    m = np.random.default_rng(sh * 1000 + sw).integers(0, 256, (sh, sw), dtype=np.uint8)
    np.testing.assert_array_equal(image.resize_nearest(m, (h, w)),
                                  cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST))


def test_format_from_magic_not_name(rng, tmp_path):
    img = _photo(rng, 20, 30)
    png_named_jpg = tmp_path / "a.jpg"
    png_named_jpg.write_bytes(image.encode_png(img))
    np.testing.assert_array_equal(image.read(png_named_jpg), img)
    with pytest.raises(image.ImageError):
        image.decode(b"GIF89a....")
    # a progressive JPEG, once refused, reads as cv2 reads it; an
    # arithmetic-coded one (SOF9) is still refused with its reason
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    np.testing.assert_array_equal(image.decode(buf.tobytes()), cv2.imdecode(buf, 1)[:, :, ::-1])
    data = bytearray(buf.tobytes())
    data[data.index(b"\xff\xc2") + 1] = 0xC9
    with pytest.raises(image.ImageError, match="arithmetic"):
        image.decode(bytes(data))
    with pytest.raises(FileNotFoundError):
        image.read(tmp_path / "missing.png")


@settings(max_examples=40, deadline=None)
@given(cut=st.floats(0.0, 1.0), flip=st.integers(0, 10_000))
def test_corrupt_jpeg_raises_or_decodes(cut, flip):
    # truncated or bit-flipped streams: an ImageError or an RGB frame of the
    # (possibly flipped) header's size, never a crash (libjpeg likewise
    # fills missing data)
    img = _photo(np.random.default_rng(1), 37, 53)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    data = bytearray(buf.tobytes())
    data[flip % len(data)] ^= 0x5A
    data = bytes(data[: max(4, int(len(data) * cut))])
    try:
        out = image.decode(data)
    except image.ImageError:
        return
    assert out.ndim == 3 and out.shape[2] == 3 and out.dtype == np.uint8
