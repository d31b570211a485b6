"""The port's image IO (``data/image_io.py``) on the CPU: the numpy PNG
codec against cv2 and PIL bit for bit, ``resize_bilinear`` and the card's
``resize_taps`` against ``cv2.resize``, and the CPU JPEG route against the
PIL route the datasets used before. The nvJPEG route runs on the card only
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); its fixtures, two small
JPEGs and their libjpeg decodes, are checked here."""

import io
import pathlib
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from transmvsnet_tpu_torch.data import image_io

FIXTURES = pathlib.Path(__file__).resolve().parent / "data" / "torch_codec"
FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH"]


def _image(shape, seed=0):
    """Smooth gradients with a noisy band: every PNG filter wins some rows."""
    rng = np.random.RandomState(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2) % 256
    img = np.stack([base, (base * 7) % 256, 255 - base, (xx * 5) % 256], axis=-1)
    img = img[..., : (shape[2] if len(shape) == 3 else 1)]
    img = img.astype(np.uint8)
    img[h // 3 : h // 2] = rng.randint(0, 256, img[h // 3 : h // 2].shape)
    return img if len(shape) == 3 else img[..., 0]


def _filter_types(png: bytes) -> set:
    """The row filter types a PNG's IDAT uses."""
    width, height, _, ctype = struct.unpack(">IIBB", png[16:26])
    idat, pos = b"", 8
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos : pos + 4])
        if png[pos + 4 : pos + 8] == b"IDAT":
            idat += png[pos + 8 : pos + 8 + n]
        pos += 12 + n
    stride = width * {0: 1, 2: 3, 6: 4}[ctype] + 1
    return set(np.frombuffer(zlib.decompress(idat), np.uint8)[::stride].tolist())


def _cv2_rgb(png: bytes) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB if img.shape[2] == 3 else cv2.COLOR_BGRA2RGBA)
    return img


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "rgb", "rgba"])
@pytest.mark.parametrize("png_filter", FILTERS)
def test_cv2_pngs_decode_like_cv2(png_filter, channels):
    img = _image((37, 53, channels) if channels > 1 else (37, 53), seed=channels)
    bgr = img if channels == 1 else cv2.cvtColor(img, cv2.COLOR_RGB2BGR if channels == 3 else cv2.COLOR_RGBA2BGRA)
    flag = getattr(cv2, f"IMWRITE_PNG_FILTER_{png_filter}")
    ok, buf = cv2.imencode(".png", bgr, [cv2.IMWRITE_PNG_FILTER, flag])
    assert ok
    png = buf.tobytes()
    assert _filter_types(png) == {FILTERS.index(png_filter)}
    got = image_io.decode_png(png)
    np.testing.assert_array_equal(got, _cv2_rgb(png))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_pil_pngs_decode_like_cv2_and_pil(mode):
    channels = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    img = _image((64, 96, channels) if channels > 1 else (64, 96), seed=7)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    png = buf.getvalue()
    assert len(_filter_types(png)) >= 2  # PIL picks a filter per row
    got = image_io.decode_png(png)
    np.testing.assert_array_equal(got, _cv2_rgb(png))
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(png))))


def test_filters_mixed_in_one_file():
    """cv2's adaptive choice mixes filter types between rows."""
    img = _image((64, 96, 3), seed=3)
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    png = buf.tobytes()
    assert len(_filter_types(png)) >= 3
    np.testing.assert_array_equal(image_io.decode_png(png), _cv2_rgb(png))


@pytest.mark.parametrize("shape", [(31, 45), (31, 45, 3)])
def test_own_pngs_read_back_bit_for_bit(tmp_path, shape):
    img = _image(shape, seed=11)
    path = str(tmp_path / "a.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(image_io.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(_cv2_rgb(open(path, "rb").read()), img)
    assert _filter_types(open(path, "rb").read()) == {0}


def test_png_refuses_what_it_does_not_decode(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        image_io.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.decode_png(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="uint8"):
        image_io.encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        image_io.encode_png(np.zeros((4, 4, 4), np.uint8))


@pytest.mark.parametrize("src,dst", [((1200, 1600), (864, 1152)), ((1080, 1920), (1056, 1920)),
                                     ((64, 96), (150, 200))], ids=["dtu", "tnt", "upscale"])
def test_resize_matches_cv2(src, dst):
    img = np.random.RandomState(0).rand(*src, 3).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]))
    # The CPU route is cv2 itself; the card's route, run here on CPU
    # tensors, agrees to float32 rounding (1.8e-7 at most here).
    np.testing.assert_array_equal(image_io.resize_bilinear(torch.from_numpy(img), dst).numpy(), want)
    got = image_io.resize_taps(torch.from_numpy(img), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_taps_on_a_single_channel_and_identity():
    img = np.random.RandomState(1).rand(37, 53).astype(np.float32)
    np.testing.assert_allclose(image_io.resize_taps(torch.from_numpy(img), (64, 64)).numpy(),
                               cv2.resize(img, (64, 64)), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(image_io.resize_taps(torch.from_numpy(img), (37, 53)).numpy(), img)


@pytest.mark.parametrize("name", ["synthetic_420", "synthetic_444"])
def test_cpu_jpeg_route_is_the_pil_route(name):
    path = str(FIXTURES / f"{name}.jpg")
    want = np.asarray(Image.open(path), dtype=np.float32) / 255.0
    got = image_io.read_image(path, "cpu")
    assert got.dtype == torch.float32 and got.shape == (64, 96, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,sampling", [("synthetic_420", (2, 2)), ("synthetic_444", (1, 1))])
def test_codec_fixtures(name, sampling):
    """The fixtures the card's decode is held against: baseline JPEGs with
    the stated luma sampling, and their stored libjpeg decodes."""
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    sof = data.index(b"\xff\xc0")  # baseline
    factors = data[sof + 11]
    assert (factors >> 4, factors & 15) == sampling
    np.testing.assert_array_equal(np.load(FIXTURES / f"{name}.npy"),
                                  np.asarray(Image.open(FIXTURES / f"{name}.jpg").convert("RGB")))


def test_cpu_png_route_and_write_jpeg(tmp_path):
    img = _image((32, 48, 3), seed=5)
    image_io.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "a.png"), "cpu").numpy(),
                                  img.astype(np.float32) / 255.0)
    # The CPU JPEG writer is cv2.imwrite, as the JAX package writes.
    image_io.write_jpeg(str(tmp_path / "a.jpg"), torch.from_numpy(img))
    cv2.imwrite(str(tmp_path / "b.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    with pytest.raises(ValueError, match="uint8"):
        image_io.write_jpeg(str(tmp_path / "c.jpg"), torch.zeros(4, 4, 3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        image_io.read_image(str(tmp_path / "a.png"), "meta")


@pytest.mark.parametrize("shape", [(97, 131, 3), (40, 56, 3)])
def test_encoder_colour_conversion_is_libjpegs(shape):
    """The card's JPEG encoder takes its Y, Cb, Cr from ``rgb_to_ycc``: PIL
    (libjpeg) encodes those planes as the very file it writes from the RGB
    image, byte for byte."""
    rng = np.random.RandomState(shape[0])
    for rgb in (_image(shape, seed=1), rng.randint(0, 256, shape).astype(np.uint8)):
        ycc = image_io.rgb_to_ycc(torch.from_numpy(rgb)).numpy()
        from_rgb, from_ycc = io.BytesIO(), io.BytesIO()
        Image.fromarray(rgb).save(from_rgb, "JPEG", quality=95)
        Image.fromarray(ycc, "YCbCr").save(from_ycc, "JPEG", quality=95)
        assert from_rgb.getvalue() == from_ycc.getvalue()


@pytest.mark.parametrize("shape", [(6, 8), (7, 9), (1, 1)])
def test_chroma_downsampling_is_libjpegs(shape):
    """``downsample_h2v2`` against jcsample.c's h2v2_downsample written out
    as its loops: edges repeated, bias 1, 2, 1, 2 along each output row."""
    c = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    h, w = -(-shape[0] // 2), -(-shape[1] // 2)
    padded = np.pad(c.astype(int), ((0, 2 * h - shape[0]), (0, 2 * w - shape[1])), mode="edge")
    want = np.zeros((h, w), np.uint8)
    for oy in range(h):
        bias = 1
        for ox in range(w):
            s = padded[2 * oy : 2 * oy + 2, 2 * ox : 2 * ox + 2].sum()
            want[oy, ox] = (s + bias) >> 2
            bias ^= 3
    np.testing.assert_array_equal(image_io.downsample_h2v2(torch.from_numpy(c)).numpy(), want)
