"""Validation samples and predicted-vs-real frame grids (port of
vla_rft_tpu/utils/generations_logger.py).

`ValidationGenerationsLogger` writes one JSON line per (prompt, response,
score) sample to `{log_dir}/step_{step}.jsonl`, the reference's file.
`save_frame_grid` writes one PNG of rows [real | predicted | abs diff],
frames tiled left to right, with the reward in the file name.  The
reference writes the PNG with PIL (or tensorflow); here `write_png`
encodes it with the standard library (zlib and struct): one IHDR, one IDAT
of filter-0 rows and one IEND chunk.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np


class ValidationGenerationsLogger:
    def __init__(self, log_dir: str = "logs/val_generations"):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)

    def log(self, samples: List[Sequence], step: int) -> None:
        """samples: (prompt, response, score) tuples."""
        path = os.path.join(self.log_dir, f"step_{step}.jsonl")
        with open(path, "w") as f:
            for s in samples:
                rec = {"prompt": str(s[0]), "response": str(s[1]), "score": float(s[2])}
                f.write(json.dumps(rec) + "\n")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    image = np.ascontiguousarray(image, np.uint8)
    H, W, C = image.shape
    if C != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {image.shape}")
    raw = np.concatenate([np.zeros((H, 1), np.uint8), image.reshape(H, W * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)  # 8-bit truecolour, no interlace
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_frame_grid(real: np.ndarray, pred: np.ndarray, path: str,
                    reward: Optional[float] = None) -> str:
    """(F, H, W, 3) real and predicted frames in [0, 1] -> one PNG of rows
    [real | pred | abs diff]; the reward goes into the file name.  Returns
    the path written."""
    real = np.clip(np.asarray(real, np.float32), 0, 1)
    pred = np.clip(np.asarray(pred, np.float32), 0, 1)
    diff = np.abs(real - pred)
    rows = [np.concatenate(list(x), axis=1) for x in (real, pred, diff)]
    grid = (np.concatenate(rows, axis=0) * 255).astype(np.uint8)
    if reward is not None:
        base, ext = os.path.splitext(path)
        path = f"{base}_reward{reward:.4f}{ext or '.png'}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, grid)
    return path
