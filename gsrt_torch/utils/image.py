"""Image I/O and quality metrics (counterpart of `gsrt.utils.image`).

PNG files are written and read by a codec of the port's own on the
standard library (`zlib`, `struct`), so no image library is needed:

* the encoder writes 8-bit RGB, non-interlaced, every row with the Sub
  filter (grey input is repeated to three channels, as in `gsrt`);
* the decoder reads non-interlaced 8-bit grey, grey + alpha, RGB and
  RGBA, all five filter types, over any number of IDAT chunks, and checks
  every chunk's CRC. It raises ValueError naming what it does not read:
  interlaced files, palette images and bit depths other than 8.

`load_png` returns RGB float32 in [0, 1], as `gsrt`'s `convert("RGB")`
does: alpha is dropped and grey repeated. Images may be NumPy arrays or
tensors on any device; results are NumPy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type → samples a pixel
_ZLIB_LEVEL = 6                         # zlib's default


def as_numpy(img) -> np.ndarray:
    """An array or a tensor (any device) as a NumPy array."""
    if hasattr(img, "detach"):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_uint8(img) -> np.ndarray:
    return (np.clip(as_numpy(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _rgb8(img) -> np.ndarray:
    arr = to_uint8(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    return arr


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 → the bytes of an 8-bit RGB PNG file."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 \
            or 0 in rgb.shape:
        raise ValueError(f"encode_png takes a non-empty [H, W, 3] uint8 "
                         f"image, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    # Sub filter: each byte minus the byte one pixel to its left (mod 256)
    sub = rgb.copy()
    sub[:, 1:] -= rgb[:, :-1]
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub.reshape(h, w * 3)],
                         1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), _ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def _unfilter_sequential(ftype: int, line: np.ndarray, prev: np.ndarray,
                         bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4) rows: each byte depends on the one a
    pixel to its left after reconstruction, so they go byte by byte."""
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG file → [H, W, C] uint8, C = 1 (grey), 2 (grey +
    alpha), 3 (RGB) or 4 (RGBA)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        head = data[pos:pos + 8]
        if len(head) != 8:
            raise ValueError("truncated PNG chunk")
        n, kind = struct.unpack(">I4s", head)
        body, crc = data[pos + 8:pos + 8 + n], data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"CRC mismatch in PNG chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype == 3:
        raise ValueError("palette PNG images (colour type 3) are not read")
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG images are not read (8-bit only)")
    if interlace:
        raise ValueError("interlaced PNG images are not read")
    if ctype not in _CHANNELS or comp or filt:
        raise ValueError(f"PNG colour type {ctype}, compression {comp}, "
                         f"filter method {filt} is not a valid image")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data of {len(raw)} bytes for "
                         f"{w}x{h}x{bpp}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            out[y] = line
        elif ftype == 1:
            out[y] = np.cumsum(line.reshape(w, bpp), 0,
                               dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            out[y] = line + prev
        elif ftype in (3, 4):
            out[y] = _unfilter_sequential(ftype, line, prev, bpp)
        else:
            raise ValueError(f"unknown PNG filter type {ftype} in row {y}")
        prev = out[y]
    return out.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    """A PNG file → [H, W, 3] uint8 RGB (alpha dropped, grey repeated)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def png_bytes(img) -> bytes:
    """An image in [0, 1] ([H, W] grey or [H, W, 3]; array or tensor) as
    the bytes of an 8-bit RGB PNG file."""
    return encode_png(_rgb8(img))


def save_png(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def load_png(path: str) -> np.ndarray:
    return np.asarray(read_png(path), np.float32) / 255.0


def dump_image_binary(path: str, img) -> None:
    """Reference-compatible dump: per pixel, RGB bytes + linear offset
    (vulkan_ray_tracing.cc image_store → image.binary)."""
    arr = _rgb8(img)
    h, w = arr.shape[:2]
    rec = np.zeros(h * w, dtype=np.dtype([("r", "u1"), ("g", "u1"),
                                          ("b", "u1"), ("off", "<u4")]))
    flat = arr.reshape(h * w, arr.shape[-1])
    rec["r"], rec["g"], rec["b"] = flat[:, 0], flat[:, 1], flat[:, 2]
    rec["off"] = np.arange(h * w, dtype=np.uint32)
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def psnr(a, b, max_val: float = 1.0) -> float:
    a = np.asarray(as_numpy(a), np.float64)
    b = np.asarray(as_numpy(b), np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val ** 2 / mse))


def ssim(a, b, max_val: float = 1.0, win: int = 7) -> float:
    """Mean SSIM with a uniform `win`×`win` window over the grey (channel
    mean) of RGB inputs, valid windows only. `trainer._ssim` is another
    metric (11×11). Inputs smaller than the window are rejected."""
    a = np.asarray(as_numpy(a), np.float64)
    b = np.asarray(as_numpy(b), np.float64)
    if a.ndim == 3:
        a = a.mean(-1)
    if b.ndim == 3:
        b = b.mean(-1)
    if min(a.shape) < win or a.shape != b.shape:
        raise ValueError(
            f"ssim needs matching images at least {win}px per side, "
            f"got {a.shape} vs {b.shape}")

    def filt(x):
        # separable uniform filter, 'valid' windows
        k = np.ones(win) / win
        x = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, x)
        x = np.apply_along_axis(lambda c: np.convolve(c, k, "valid"), 0, x)
        return x

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a ** 2
    var_b = filt(b * b) - mu_b ** 2
    cov = filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(s.mean())
