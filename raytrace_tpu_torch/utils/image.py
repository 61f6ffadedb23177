"""PNG encode/decode with the standard library only (zlib + struct).

Port of ``raytrace_tpu/utils/image.py`` without its optional native Paeth
filter: scanlines use filter type 0 (None), which every PNG reader
accepts. ``write_ppm`` and ``write_ppm_float`` write the reference's ASCII
PPM.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H,W,3) or (H,W,4) uint8 -> PNG bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8 image, got {img.dtype}")
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H,W,3|4), got {img.shape}")
    h, w, c = img.shape
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced RGB, RGBA, gray or gray-alpha PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat = 8, b""
    w = h = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNG supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        prev = out[y - 1].astype(np.int32) if y else np.zeros(stride,
                                                              np.int32)
        if f == 0:
            out[y] = line
        elif f == 2:  # Up
            out[y] = (line + prev) & 0xFF
        elif f in (1, 3, 4):  # Sub, Average, Paeth: left-to-right
            cur = out[y]
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[x] = (int(line[x]) + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter {f}")
    return out.reshape(h, w, bpp)


def write_ppm(path: str, img: np.ndarray) -> None:
    """P3 ASCII PPM from a uint8 (H,W,3) image (ppm.go:11-45)."""
    h, w = img.shape[:2]
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        for y in range(h):
            f.write(" ".join(
                f"{img[y, x, 0]} {img[y, x, 1]} {img[y, x, 2]}"
                for x in range(w)) + "\n")


def write_ppm_float(path: str, img: np.ndarray, gamma: float = 1.0) -> None:
    """PPM from an (H,W,3) linear float image, with an optional gamma
    (ppm.go:119-156)."""
    x = np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
    write_ppm(path, (x * 255).astype(np.uint8))
