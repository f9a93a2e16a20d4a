"""Minimal PNG output (stdlib zlib): frames to disk without GL.

Counterpart of ``ray_tracing_octrees_tpu/render/image.py``; the same bytes
for the same image. A tensor is copied to the host first.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def write_png(path: str, image) -> None:
    """Write HxWx3 or HxWx4 float [0,1] or uint8 image as PNG."""
    if torch.is_tensor(image):
        image = image.detach().cpu().numpy()
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
