"""Image pipeline: BMP codec, ACES tonemap + gamma, mono CSV, sentinel
scrub and RMSE, all in numpy on the host.

Counterpart of cudapathtracer_tpu/utils/image.py without its JAX variant
of the scrub: the framebuffer is copied to the host once per save.
"""

from __future__ import annotations

import os
import struct

import numpy as np

SENTINEL_NAN = (1.0, 0.0, 1.0)   # magenta
SENTINEL_INF = (0.0, 1.0, 0.0)   # green
SENTINEL_NEG = (0.0, 0.0, 1.0)   # blue


def aces_tonemap(c: np.ndarray) -> np.ndarray:
    """ACES filmic approximation."""
    A, B, C, D, E = 2.51, 0.03, 2.43, 0.59, 0.14
    return np.clip((c * (A * c + B)) / (c * (C * c + D) + E), 0.0, 1.0)


def gamma_correct(c: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    return np.power(np.clip(c, 0.0, 1.0), 1.0 / gamma)


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Decode 8-bit sRGB-ish (gamma 2.2), as the reference does on load."""
    return np.power(c, 2.2)


def scrub(acc: np.ndarray, sample_count: int) -> np.ndarray:
    """Normalize an accumulation buffer by the sample count and paint
    NaN pixels magenta, Inf green and negative blue."""
    acc = np.asarray(acc, dtype=np.float32)
    nan = np.isnan(acc).any(axis=-1)
    inf = np.isinf(acc).any(axis=-1)
    neg = (acc < 0).any(axis=-1)
    out = acc / float(max(sample_count, 1))
    out = np.where(nan[..., None], np.array(SENTINEL_NAN, np.float32), out)
    out = np.where((~nan & inf)[..., None],
                   np.array(SENTINEL_INF, np.float32), out)
    out = np.where((~nan & ~inf & neg)[..., None],
                   np.array(SENTINEL_NEG, np.float32), out)
    return out


class Image:
    """Float32 [H, W, 3] image; row 0 is the top."""

    def __init__(self, width: int, height: int,
                 pixels: np.ndarray | None = None,
                 post_process: bool = False):
        self.width = width
        self.height = height
        self.post_process = post_process
        if pixels is None:
            pixels = np.zeros((height, width, 3), dtype=np.float32)
        self.pixels = np.asarray(pixels, dtype=np.float32).reshape(
            height, width, 3)

    def post_processed(self) -> np.ndarray:
        if self.post_process:
            return gamma_correct(aces_tonemap(self.pixels))
        return np.clip(self.pixels, 0.0, 1.0)

    def save_bmp(self, path: str) -> None:
        save_bmp(path, self.post_processed())

    def save_csv_mono(self, path: str) -> None:
        """Red channel per row as CSV, for numeric diffing."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savetxt(path, self.pixels[..., 0], delimiter=",", fmt="%.9g")


def save_bmp(path: str, rgb01: np.ndarray) -> None:
    """Write a 24-bit uncompressed BMP. rgb01: [H, W, 3] in [0,1]."""
    h, w = rgb01.shape[:2]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    row_size = (3 * w + 3) & ~3
    image_size = row_size * h
    off = 14 + 40
    file_header = struct.pack("<2sIHHI", b"BM", off + image_size, 0, 0, off)
    info_header = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                              image_size, 0, 0, 0, 0)
    u8 = (np.clip(rgb01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    bgr = u8[::-1, :, ::-1]  # bottom-up rows, BGR order
    rows = np.zeros((h, row_size), dtype=np.uint8)
    rows[:, : 3 * w] = bgr.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(file_header)
        f.write(info_header)
        f.write(rows.tobytes())


def load_bmp(path: str, decode_srgb: bool = True) -> np.ndarray:
    """Read a 24-bit BMP -> [H, W, 3] float32 (linear if decode_srgb)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    off = struct.unpack_from("<I", data, 10)[0]
    w, h = struct.unpack_from("<ii", data, 18)
    bpp = struct.unpack_from("<H", data, 28)[0]
    if bpp != 24:
        raise ValueError(f"{path}: only 24-bit BMP supported, got {bpp}")
    flip = h > 0
    h = abs(h)
    row_size = (3 * w + 3) & ~3
    rows = np.frombuffer(data, dtype=np.uint8, count=row_size * h, offset=off)
    rows = rows.reshape(h, row_size)[:, : 3 * w].reshape(h, w, 3)
    rgb = rows[..., ::-1].astype(np.float32) / 255.0
    if flip:
        rgb = rgb[::-1]
    if decode_srgb:
        rgb = srgb_to_linear(rgb)
    return np.ascontiguousarray(rgb)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error between two HDR images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
