"""Image reading, writing and resizing for the datasets, the inference CLI
and the fuser, routed by device.

- JPEG, on a CUDA device: nvJPEG (``csrc/image_codec.cu``, linked with the
  CUDA toolkit's ``libnvjpeg``), decoding straight to RGB in device
  memory, and encoding at cv2.imwrite's defaults (quality 95, 4:2:0) from
  libjpeg's own colour conversion and downsampling, computed on the card
  (``rgb_to_ycc``, ``downsample_h2v2``). On the CPU: PIL to read and cv2 to write, imported
  inside the functions, as the JAX package does. The card's route never
  falls back to the CPU's: a missing ``libnvjpeg`` or a failed decode
  raises. nvJPEG is not libjpeg: its IDCT, chroma upsampling and colour
  conversion differ, so its decode of a file differs from PIL's by under a
  level on average and a few levels at most; the CPU tests compare the CPU
  route and the encoder's front end only.
- PNG, on every device: decoded and encoded here on the host with the
  standard library's ``zlib`` (8-bit grey, RGB and RGBA, non-interlaced;
  all five row filters), bit for bit what ``cv2.imread`` and PIL decode.
  The rows are unfiltered by ``png_unfilter`` (``csrc/png_unfilter.cu``,
  host code built with the kernels and called through ctypes, without the
  interpreter lock) for a CUDA device, and by its plain numpy version
  ``_unfilter`` on the CPU: the Average and Paeth filters make each byte
  depend on its left neighbour, so the numpy version walks the
  anti-diagonals, one numpy step per diagonal (H + W steps).
- ``resize_bilinear``: ``cv2.resize``'s ``INTER_LINEAR`` on float input:
  ``resize_taps`` in torch on the card, cv2 on the CPU.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_QUALITY = 95  # cv2.imwrite's default
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels (8-bit)
_count_lock = threading.Lock()  # the data loader's threads decode concurrently


def _check_device(device: torch.device) -> None:
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"images are read on cuda or cpu, got {device}")


# --- PNG -------------------------------------------------------------------


def _unfilter(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Reverses the PNG row filters. raw [H, W, bpp] uint8 (filter bytes
    removed), ftype [H] in 0-4. Pixel (y, x) depends on (y, x-1), (y-1, x)
    and (y-1, x-1), so the pixels of one anti-diagonal y + x = d are
    independent given the diagonals before it."""
    H, W, _ = raw.shape
    if not ftype.any():
        return raw.copy()
    out = np.zeros((H + 1, W + 1, bpp), np.int16)  # a zero row above and column left
    raw16 = raw.astype(np.int16)
    for d in range(H + W - 1):
        ys = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        xs = d - ys
        a = out[ys + 1, xs]  # left
        b = out[ys, xs + 1]  # up
        c = out[ys, xs]  # up-left
        t = ftype[ys][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (raw16[ys, xs] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def png_unfilter_library() -> ctypes.CDLL:
    """The compiled unfilter, built with the kernels at first use."""
    from transmvsnet_tpu_torch.ops.cuda import build

    lib = build.library("png_unfilter")
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


def png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """``_unfilter`` by the compiled routine: rows [H, 1 + W * bpp] uint8,
    each row its filter type and its filtered bytes, to [H, W, bpp].
    ``png_unfilter.launches`` counts the calls."""
    from transmvsnet_tpu_torch.ops.cuda import build

    if rows.dtype != np.uint8 or rows.ndim != 2 or (rows.shape[1] - 1) % bpp:
        raise ValueError(f"png_unfilter takes uint8 [H, 1 + W * {bpp}], got {rows.dtype} {rows.shape}")
    lib = png_unfilter_library()
    rows = np.ascontiguousarray(rows)
    height, stride = rows.shape
    out = np.empty((height, (stride - 1) // bpp, bpp), np.uint8)
    build.check(lib, "png_unfilter", lib.png_unfilter(rows.ctypes.data, height, stride, bpp, out.ctypes.data))
    with _count_lock:
        png_unfilter.launches += 1
    return out


png_unfilter.launches = 0


def decode_png(data: bytes, device: str | torch.device = "cpu") -> np.ndarray:
    """An 8-bit grey, RGB or RGBA PNG as uint8 [H, W] or [H, W, C], as
    ``np.asarray(PIL.Image.open(...))`` gives it, on the host: for a CUDA
    ``device`` unfiltered by ``png_unfilter``, else by ``_unfilter``."""
    device = torch.device(device)
    _check_device(device)
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0]:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, interlace {interlace}")
    bpp = _PNG_CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != height * (width * bpp + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {height * (width * bpp + 1)}")
    rows = rows.reshape(height, width * bpp + 1)
    if (rows[:, 0] > 4).any():
        raise ValueError("PNG row filter type above 4")
    if device.type == "cuda":
        img = png_unfilter(rows, bpp)
    else:
        img = _unfilter(rows[:, 1:].reshape(height, width, bpp), rows[:, 0], bpp)
    return img[..., 0] if bpp == 1 else img


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (grey) or [H, W, 3] (RGB) as a PNG with filter 0 on
    every row."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_png takes uint8 [H, W] or [H, W, 3], got {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    return PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def read_png(path: str, device: str | torch.device = "cpu") -> np.ndarray:
    """``decode_png`` of a file: uint8 on the host, unfiltered for ``device``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), device)


def png_rgb(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as RGB [H, W, 3]: a grey PNG's channel repeated, an
    RGBA PNG's alpha dropped."""
    return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img[..., :3]


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# --- JPEG through nvJPEG ----------------------------------------------------


def _codec() -> ctypes.CDLL:
    from transmvsnet_tpu_torch.ops.cuda import build

    lib = build.library("image_codec")
    ptr, size_t, int_p = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)
    lib.image_codec_jpeg_info.argtypes = [ptr, size_t, int_p, int_p, int_p]
    lib.image_codec_jpeg_decode.argtypes = [ptr, size_t, ptr, ctypes.c_int, ctypes.c_int, ptr]
    lib.image_codec_jpeg_encode.argtypes = [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr,
                                            size_t, ctypes.POINTER(size_t), ptr]
    for fn in (lib.image_codec_jpeg_info, lib.image_codec_jpeg_decode, lib.image_codec_jpeg_encode):
        fn.restype = ctypes.c_int
    return lib


def jpeg_decode(data: bytes, device: torch.device) -> torch.Tensor:
    """The JPEG ``data`` decoded by nvJPEG into RGB uint8 [H, W, 3] on the
    CUDA ``device``. ``jpeg_decode.launches`` counts the decodes."""
    from transmvsnet_tpu_torch.ops.cuda import build

    lib = _codec()
    buf = np.frombuffer(data, np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        build.check(lib, "image_codec",
                    lib.image_codec_jpeg_info(buf.ctypes.data, buf.size, ctypes.byref(w), ctypes.byref(h),
                                              ctypes.byref(c)))
        out = torch.empty((h.value, w.value, 3), dtype=torch.uint8, device=device)
        build.check(lib, "image_codec",
                    lib.image_codec_jpeg_decode(buf.ctypes.data, buf.size, out.data_ptr(), w.value, h.value,
                                                build.stream_handle(out)))
    with _count_lock:
        jpeg_decode.launches += 1
    return out


def rgb_to_ycc(rgb: torch.Tensor) -> torch.Tensor:
    """libjpeg's colour conversion (jccolor.c, 16-bit fixed point) of RGB
    uint8 [H, W, 3], on its device: Y, Cb, Cr uint8 [H, W, 3]."""
    r, g, b = rgb.to(torch.int32).unbind(-1)
    offset = (128 << 16) + 32767
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + offset) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + offset) >> 16
    return torch.stack([y, cb, cr], dim=-1).to(torch.uint8)


def downsample_h2v2(c: torch.Tensor) -> torch.Tensor:
    """libjpeg's 2x2 chroma downsampling (jcsample.c, h2v2_downsample) of
    uint8 [H, W]: the last row and column repeated to even sizes, each 2x2
    sum plus a bias of 1, 2, 1, 2, ... along the row, shifted by 2."""
    c = c.to(torch.int32)
    if c.shape[0] % 2:
        c = torch.cat([c, c[-1:]])
    if c.shape[1] % 2:
        c = torch.cat([c, c[:, -1:]], dim=1)
    total = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
    bias = 1 + torch.arange(total.shape[1], device=c.device, dtype=torch.int32) % 2
    return ((total + bias) >> 2).to(torch.uint8)


def jpeg_encode(rgb: torch.Tensor, quality: int = JPEG_QUALITY) -> bytes:
    """RGB uint8 [H, W, 3] on a CUDA device encoded as a baseline JPEG with
    4:2:0 chroma: libjpeg's colour conversion and downsampling
    (``rgb_to_ycc``, ``downsample_h2v2``) on the card, then nvJPEG's DCT
    and entropy coding.
    ``jpeg_encode.launches`` counts the encodes."""
    from transmvsnet_tpu_torch.ops.cuda import build

    lib = _codec()
    h, w = rgb.shape[:2]
    ycc = rgb_to_ycc(rgb)
    planes = [ycc[..., 0].contiguous(), downsample_h2v2(ycc[..., 1]), downsample_h2v2(ycc[..., 2])]
    out = np.empty(3 * h * w + 65536, np.uint8)  # more than any JPEG of the image at quality <= 100
    length = ctypes.c_size_t()
    with torch.cuda.device(rgb.device):
        build.check(lib, "image_codec",
                    lib.image_codec_jpeg_encode(*(p.data_ptr() for p in planes), w, h, quality, out.ctypes.data,
                                                out.size, ctypes.byref(length), build.stream_handle(rgb)))
    with _count_lock:
        jpeg_encode.launches += 1
    return out[: length.value].tobytes()


jpeg_decode.launches = 0
jpeg_encode.launches = 0


# --- Routed by device -------------------------------------------------------


def read_image(path: str, device: str | torch.device = "cuda") -> torch.Tensor:
    """An RGB image file as float32 [H, W, 3] in [0, 1] on ``device``: a
    PNG through ``decode_png`` (a grey PNG's channel repeated, an RGBA
    PNG's alpha dropped), a JPEG through nvJPEG on CUDA and PIL on the
    CPU."""
    device = torch.device(device)
    _check_device(device)
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        u8 = torch.from_numpy(np.ascontiguousarray(png_rgb(decode_png(data, device)))).to(device)
    elif device.type == "cuda":
        u8 = jpeg_decode(data, device)
    else:
        from PIL import Image

        with Image.open(path) as im:
            u8 = torch.from_numpy(np.asarray(im.convert("RGB")).copy())
    return u8.float() / 255.0


def write_jpeg(path: str, rgb_u8: torch.Tensor) -> None:
    """Write RGB uint8 [H, W, 3] as a JPEG at quality 95 with 4:2:0 chroma:
    through nvJPEG for a CUDA tensor, cv2 for a CPU one."""
    _check_device(rgb_u8.device)
    if rgb_u8.dtype != torch.uint8 or rgb_u8.ndim != 3 or rgb_u8.shape[2] != 3:
        raise ValueError(f"write_jpeg takes uint8 [H, W, 3], got {rgb_u8.dtype} {tuple(rgb_u8.shape)}")
    if rgb_u8.device.type == "cuda":
        data = jpeg_encode(rgb_u8)
        with open(path, "wb") as f:
            f.write(data)
        return
    import cv2

    if not cv2.imwrite(path, cv2.cvtColor(rgb_u8.numpy(), cv2.COLOR_RGB2BGR)):
        raise OSError(f"cv2.imwrite could not write {path}")


# --- Resize -----------------------------------------------------------------


def _taps(src: int, dst: int, device: torch.device):
    """cv2's INTER_LINEAR taps along one axis: source position (i + 0.5) *
    src / dst - 0.5 and its fraction in float64, the fraction then rounded
    to float32; clamped at both edges. Returns (i0, i1, w0, w1)."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = (f - i0).astype(np.float32)
    frac[(i0 < 0) | (i0 >= src - 1)] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    i1 = np.minimum(i0 + 1, src - 1)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(1.0 - frac).to(device), torch.from_numpy(frac).to(device))


def resize_taps(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, (w, h))`` (``INTER_LINEAR``) of float32 img [H, W]
    or [H, W, C] in torch on img's device: a pass along x, then one along y,
    with cv2's taps. Agrees with cv2 to float32 rounding (cv2's vector code
    orders some products otherwise); not ``F.interpolate``, whose source
    positions come from a float32 scale and land up to 1.4e-4 away from
    cv2's at 1600x1200 -> 1152x864."""
    h, w = size
    H, W = img.shape[:2]
    if (h, w) == (H, W):
        return img.clone()
    x0, x1, a0, a1 = _taps(W, w, img.device)
    y0, y1, b0, b1 = _taps(H, h, img.device)
    extra = (None,) * (img.ndim - 2)
    rows = img[:, x0] * a0[(slice(None), *extra)] + img[:, x1] * a1[(slice(None), *extra)]
    return rows[y0] * b0[(slice(None), None, *extra)] + rows[y1] * b1[(slice(None), None, *extra)]


def resize_bilinear(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, (w, h))`` (``INTER_LINEAR``) of float32 img [H, W]
    or [H, W, 3], size (h, w), on img's device: ``resize_taps`` on CUDA,
    cv2 itself (imported here) for a CPU tensor, bit for bit what the JAX
    package computes."""
    _check_device(img.device)
    if img.device.type == "cuda":
        return resize_taps(img, size)
    import cv2

    return torch.from_numpy(cv2.resize(np.ascontiguousarray(img.numpy()), (size[1], size[0])))
